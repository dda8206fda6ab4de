"""Overlap-save vs the oracle: tap/nfft geometries, f32 SNR, streaming
history, odd sizes, config-4 sizes."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.overlap_save import overlap_save


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(41)


@pytest.mark.parametrize("taps,nfft", ((64, 1024), (64, 256), (512, 2048)))
def test_vs_oracle_f64(rng, taps, nfft):
    x = rng.standard_normal((3, 9000))
    h = oracle.design_fir(taps, 0.3) if taps >= 8 else rng.standard_normal(taps)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(3)])
    out = np.asarray(overlap_save(x, h, nfft))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


def test_f32_snr(rng):
    x = rng.standard_normal((8, 16384)).astype(np.float32)
    h = oracle.design_fir(64, 0.25)
    ref = np.stack([oracle.fir_direct(x[i].astype(np.float64), h) for i in range(8)])
    out = np.asarray(overlap_save(x, h, 1024))
    assert oracle.snr_db(ref, out) >= 60.0


def test_history_streaming(rng):
    x = rng.standard_normal(8192)
    h = oracle.design_fir(128, 0.2)
    ref = oracle.fir_direct(x, h)
    hist = np.zeros((1, 127))
    outs = []
    for k in range(0, 8192, 2048):
        blk = x[None, k : k + 2048]
        outs.append(np.asarray(overlap_save(blk, h, 2048, history=hist))[0])
        hist = np.concatenate([hist, blk], axis=-1)[:, -127:]
    np.testing.assert_allclose(np.concatenate(outs), ref, rtol=1e-8, atol=1e-8)


def test_odd_batch_and_length(rng):
    x = rng.standard_normal((5, 3333))
    h = oracle.design_fir(33, 0.4)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(5)])
    out = np.asarray(overlap_save(x, h, 512))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("taps,nfft", ((512, 4096), (4096, 16384)))
def test_large_nfft(rng, taps, nfft):
    """Large FFT sizes, up to config 4's (BASELINE.json:10)."""
    x = rng.standard_normal((2, 4 * nfft))
    h = oracle.design_fir(taps, 0.1)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(2)])
    out = np.asarray(overlap_save(x, h, nfft))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("taps,nfft", ((64, 256), (193, 512), (385, 512)))
def test_unaligned_emission_repair(rng, taps, nfft):
    """Geometries where taps-1 leaves only a few valid samples per
    overlap-save block (block size nfft-taps+1 small against nfft),
    whole-file and streamed with history across every block."""
    x = rng.standard_normal((3, 4000))
    h = oracle.design_fir(taps, 0.3)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(3)])
    out = np.asarray(overlap_save(x, h, nfft))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    # streaming with history crosses the emission slice at every block
    hist = np.zeros((3, taps - 1))
    outs = []
    for k in range(0, 4000, 1000):
        blk = x[:, k : k + 1000]
        outs.append(np.asarray(
            overlap_save(blk, h, nfft, history=hist)))
        hist = np.concatenate([hist, blk], axis=-1)[:, -(taps - 1):]
    np.testing.assert_allclose(np.concatenate(outs, axis=-1), ref,
                               rtol=1e-8, atol=1e-8)
