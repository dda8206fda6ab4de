"""Spectral noise gate vs the oracle: lengths, f32 SNR, odd batch,
parameters, nfft 2048, release smoothing."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.effects.noise_gate import noise_gate


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(43)


def _mk(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


@pytest.mark.parametrize("n", (48128, 32768, 16384 + 256 * 3))
def test_vs_oracle_f64(rng, n):
    x = _mk(rng, 2, n)
    ref = np.stack([oracle.noise_gate(x[c]) for c in range(2)])
    out = np.asarray(noise_gate(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_f32_snr(rng):
    x = _mk(rng, 4, 32768).astype(np.float32)
    ref = np.stack([oracle.noise_gate(x[c].astype(np.float64)) for c in range(4)])
    out = np.asarray(noise_gate(x))
    assert oracle.snr_db(ref, out) >= 60.0


def test_odd_batch(rng):
    x = _mk(rng, 3, 16384)
    ref = np.stack([oracle.noise_gate(x[c]) for c in range(3)])
    out = np.asarray(noise_gate(x))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_params(rng):
    x = _mk(rng, 1, 16384)
    ref = oracle.noise_gate(x[0], nfft=512, hop=128, threshold_db=10.0,
                            reduction_db=40.0, noise_frames=4, window_kind="hamming")
    out = np.asarray(noise_gate(x, nfft=512, hop=128, threshold_db=10.0,
                                reduction_db=40.0, noise_frames=4,
                                window_kind="hamming"))[0]
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_nfft_2048(rng):
    x = _mk(rng, 2, 65536)
    ref = np.stack([oracle.noise_gate(x[c], nfft=2048, hop=512) for c in range(2)])
    out = np.asarray(noise_gate(x, nfft=2048, hop=512))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("release", (0.5, 0.9))
def test_release_smoothing(rng, release):
    x = _mk(rng, 2, 32768)
    ref = np.stack([oracle.noise_gate(x[c], release=release) for c in range(2)])
    out = np.asarray(noise_gate(x, release=release))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)
