"""Direct FIR and polyphase resampler vs the oracle (SURVEY.md §4.2):
tap counts, f64 exactness, streaming history, odd sizes, rate ratios."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import fir_direct
from audiosignalprocess_tpu.ops.resample import resample_poly


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(31)


class TestFIRMac:
    @pytest.mark.parametrize("taps", (1, 7, 64, 129))
    def test_vs_oracle(self, rng, taps):
        x = rng.standard_normal((4, 4000)).astype(np.float32)
        h = rng.standard_normal(taps)
        ref = np.stack([oracle.fir_direct(x[i].astype(np.float64), h) for i in range(4)])
        out = np.asarray(fir_direct(x, h))
        assert out.shape == ref.shape
        assert oracle.snr_db(ref, out) >= 60.0

    def test_f64_exact(self, rng):
        x = rng.standard_normal((2, 1000))
        h = rng.standard_normal(33)
        ref = np.stack([oracle.fir_direct(x[i], h) for i in range(2)])
        out = np.asarray(fir_direct(x, h))
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)

    def test_history(self, rng):
        x = rng.standard_normal((1, 1024))
        h = rng.standard_normal(17)
        hist = rng.standard_normal((1, 16))
        full = np.concatenate([hist, x], axis=-1)
        ref = oracle.fir_direct(full[0], h)[16:]
        out = np.asarray(fir_direct(x, h, history=hist))[0]
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)

    def test_odd_sizes(self, rng):
        """Odd length and odd batch."""
        x = rng.standard_normal((3, 777))
        h = rng.standard_normal(9)
        ref = np.stack([oracle.fir_direct(x[i], h) for i in range(3)])
        out = np.asarray(fir_direct(x, h))
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)


class TestResampleMac:
    @pytest.mark.parametrize("up,down", ((160, 147), (147, 160), (2, 1), (1, 2), (3, 4)))
    @pytest.mark.parametrize("zero_phase", (True, False))
    def test_vs_oracle(self, rng, up, down, zero_phase):
        x = rng.standard_normal((2, 2940))
        ref = np.stack([
            oracle.resample_poly(x[i], up, down, zero_phase=zero_phase) for i in range(2)
        ])
        out = np.asarray(resample_poly(x, up, down, zero_phase=zero_phase))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)

    def test_streaming_history(self, rng):
        up, down = 160, 147
        n = down * 64 * 3
        x = rng.standard_normal(n)
        ref = oracle.resample_poly(x, up, down, zero_phase=False)
        h = oracle.resample_filter(up, down)
        from audiosignalprocess_tpu.ops.resample import history_len

        hl = history_len(len(h), up, down)
        b = down * 64
        hist = np.zeros((1, hl))
        outs = []
        for k in range(0, n, b):
            blk = x[None, k : k + b]
            outs.append(np.asarray(resample_poly(blk, up, down, h=h, zero_phase=False,
                                                 history=hist))[0])
            hist = np.concatenate([hist, blk], axis=-1)[:, -hl:]
        np.testing.assert_allclose(np.concatenate(outs), ref, rtol=1e-8, atol=1e-8)

    def test_f32_snr(self, rng):
        x = rng.standard_normal((4, 14700)).astype(np.float32)
        ref = np.stack([
            oracle.resample_poly(x[i].astype(np.float64), 160, 147) for i in range(4)
        ])
        out = np.asarray(resample_poly(x, 160, 147))
        assert oracle.snr_db(ref, out) >= 60.0
