"""FFT family parity tests: every impl vs the pinned float64 oracle.

Acceptance (SURVEY.md §4.1): >= 60 dB SNR for f32 paths, near machine
precision for f64; exact structural parity (shapes, bin counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops import fft as fft_ops

IMPLS = ("radix2", "splitradix", "matmul", "xla")
SIZES = (2, 4, 8, 64, 256, 1024, 4096)


def _snr_c(ref, test):
    err = np.abs(ref - np.asarray(test))
    p = np.sum(np.abs(ref) ** 2)
    e = np.sum(err**2)
    return np.inf if e == 0 else 10.0 * np.log10(p / e)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


class TestOracleSelfConsistency:
    """The pinned oracle must agree with numpy.fft (the gold standard)."""

    @pytest.mark.parametrize("n", SIZES)
    def test_radix2_vs_numpy(self, rng, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(oracle.fft_radix2(x), np.fft.fft(x), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("n", SIZES)
    def test_splitradix_vs_numpy(self, rng, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(oracle.fft_splitradix(x), np.fft.fft(x), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("n", SIZES[1:])
    def test_rfft_vs_numpy(self, rng, n):
        x = rng.standard_normal(n)
        np.testing.assert_allclose(oracle.rfft(x), np.fft.rfft(x), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("n", SIZES[1:])
    def test_irfft_roundtrip(self, rng, n):
        x = rng.standard_normal(n)
        np.testing.assert_allclose(oracle.irfft(oracle.rfft(x), n), x, rtol=1e-9, atol=1e-9)


class TestJaxFFT:
    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("n", SIZES)
    def test_fft_f64(self, rng, impl, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ref = oracle.fft_radix2(x)
        out = fft_ops.fft(x, impl=impl)
        assert out.shape == ref.shape
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("n", (64, 1024, 4096))
    def test_fft_f32_snr(self, rng, impl, n):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        ref = oracle.fft_radix2(x.astype(np.complex128))
        out = fft_ops.fft(x, impl=impl)
        assert np.asarray(out).dtype == np.complex64
        assert _snr_c(ref, out) >= 60.0

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("n", (8, 256, 1024))
    def test_ifft_roundtrip(self, rng, impl, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        out = fft_ops.ifft(fft_ops.fft(x, impl=impl), impl=impl)
        np.testing.assert_allclose(np.asarray(out), x, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("n", (4, 64, 1024, 4096))
    def test_rfft_f64(self, rng, impl, n):
        x = rng.standard_normal(n)
        ref = oracle.rfft(x)
        out = fft_ops.rfft(x, impl=impl)
        assert out.shape[-1] == n // 2 + 1
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("n", (4, 64, 1024, 4096))
    def test_irfft_f64(self, rng, impl, n):
        x = rng.standard_normal(n)
        out = fft_ops.irfft(fft_ops.rfft(x, impl=impl), n, impl=impl)
        np.testing.assert_allclose(np.asarray(out), x, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("impl", ("radix2", "matmul"))
    def test_batched(self, rng, impl):
        x = rng.standard_normal((3, 5, 256))
        ref = np.fft.rfft(x)
        out = fft_ops.rfft(x, impl=impl)
        assert out.shape == ref.shape
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("n", (64, 1024))
    def test_rfft_f32_snr(self, rng, n):
        x = rng.standard_normal((4, n)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64))
        for impl in IMPLS:
            out = fft_ops.rfft(x, impl=impl)
            assert _snr_c(ref, out) >= 60.0, impl


class TestAutoImpl:
    """impl="auto" is one rule for every dtype and transform: AUTO_IMPL."""

    def test_resolution_cpu(self):
        from audiosignalprocess_tpu.ops.fft import AUTO_IMPL, _resolve_impl

        assert AUTO_IMPL == "xla"
        assert _resolve_impl("auto") == AUTO_IMPL
        assert _resolve_impl("matmul") == "matmul"
        assert _resolve_impl("xla") == "xla"

    def test_f64_never_pallas(self):
        """f64 resolves like f32 (no dtype branch), and no Pallas route
        exists: an unknown impl name is rejected, not routed."""
        from audiosignalprocess_tpu.ops.fft import _resolve_impl

        for name in ("pallas", "pallas_sk", "pallas_sk_split"):
            with pytest.raises(ValueError, match="unknown FFT impl"):
                _resolve_impl(name)
        x = np.random.default_rng(1).standard_normal((2, 64))
        np.testing.assert_array_equal(
            np.asarray(fft_ops.rfft(x, impl="auto")),
            np.asarray(fft_ops.rfft(x, impl="xla")))

    def test_auto_end_to_end(self, rng):
        import numpy as np
        from audiosignalprocess_tpu.ops import fft as fft_ops

        x = rng.standard_normal((3, 512)).astype(np.float32)
        s = np.asarray(fft_ops.rfft(x, impl="auto"))
        ref = np.fft.rfft(x.astype(np.float64))
        assert oracle.snr_db(
            np.concatenate([ref.real, ref.imag], axis=None),
            np.concatenate([s.real.astype(np.float64),
                            s.imag.astype(np.float64)], axis=None)) >= 100.0
        y = np.asarray(fft_ops.irfft(s, 512, impl="auto"))
        assert oracle.snr_db(x.astype(np.float64), y) >= 100.0


class TestSplitRealRoute:
    """The default real-transform route (impl="auto", jitted): f32
    rfft/irfft round trip vs the oracle."""

    @pytest.mark.parametrize("n", (256, 1024, 4096))
    def test_rfft_irfft_roundtrip_vs_oracle(self, rng, n):
        import jax

        x = rng.standard_normal((4, n)).astype(np.float32)
        spec = np.asarray(jax.jit(
            lambda v: fft_ops.rfft(v, impl="auto"))(x))
        ref = np.fft.rfft(x.astype(np.float64))
        err = np.abs(ref - spec.astype(np.complex128))
        snr = 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(err ** 2))
        assert snr >= 100.0
        back = np.asarray(jax.jit(lambda v: fft_ops.irfft(
            v, n, impl="auto"))(jnp.asarray(spec)))
        assert oracle.snr_db(x.astype(np.float64), back) >= 100.0


AUTO_SIZES = tuple(2 ** k for k in range(1, 15))  # 2 ... 16384
AUTO_BATCHES = ((), (3,), (2, 3))


class TestAutoVsOracle:
    """impl="auto" (XLA's FFT) vs the float64 oracle for every transform,
    power-of-two size 2..16384, dtype and (cycled) batch shape.  f64 is
    held to 1e-9 relative to the spectrum's scale; f32 to >= 100 dB SNR
    (single-precision FFT rounding is ~130 dB; the 60 dB chain bound
    leaves the rest to the stages)."""

    @staticmethod
    def _case(kind, n, dtype):
        rng = np.random.default_rng(n * 7 + len(kind))
        shape = AUTO_BATCHES[AUTO_SIZES.index(n) % 3] + (n,)
        xr = rng.standard_normal(shape)
        if kind in ("fft", "ifft"):
            x = xr + 1j * rng.standard_normal(shape)
            ref = oracle.fft_radix2(x) if kind == "fft" else oracle.ifft_radix2(x)
            return x.astype(np.complex64 if dtype == "f32" else np.complex128), ref
        if kind == "rfft":
            return xr.astype(np.float32 if dtype == "f32" else np.float64), \
                oracle.rfft(xr)
        spec = oracle.rfft(xr)
        return spec.astype(np.complex64 if dtype == "f32" else np.complex128), xr

    @pytest.mark.parametrize("dtype", ("f32", "f64"))
    @pytest.mark.parametrize("n", AUTO_SIZES)
    @pytest.mark.parametrize("kind", ("fft", "ifft", "rfft", "irfft"))
    def test_vs_oracle(self, kind, n, dtype):
        x, ref = self._case(kind, n, dtype)
        op = {"fft": fft_ops.fft, "ifft": fft_ops.ifft, "rfft": fft_ops.rfft,
              "irfft": lambda v, impl: fft_ops.irfft(v, n, impl=impl)}[kind]
        out = np.asarray(op(jnp.asarray(x), impl="auto"))
        assert out.shape == ref.shape
        if dtype == "f64":
            scale = np.max(np.abs(ref))
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * scale)
        else:
            assert _snr_c(ref, out.astype(ref.dtype)) >= 100.0


def test_irfft_real_spectrum_input():
    """A REAL-dtype spectrum (e.g. a magnitude spectrum) through irfft:
    the back-twiddles must stay complex.  Casting them to the spectrum's
    (real) dtype would discard their imaginary part on every non-xla
    impl (max abs error 0.5)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(64)
    mag = np.abs(oracle.rfft(x))
    ref = np.fft.irfft(mag, 64)
    for impl in ("matmul", "radix2"):
        out = np.asarray(fft_ops.irfft(jnp.asarray(mag, jnp.float32), 64,
                                       impl=impl))
        np.testing.assert_allclose(out, ref, atol=1e-5)
    out64 = np.asarray(fft_ops.irfft(jnp.asarray(mag), 64, impl="matmul"))
    assert out64.dtype == np.float64  # f64 real spec keeps f64 output
    np.testing.assert_allclose(out64, ref, atol=1e-12)


def test_rfft_complex_input_raises():
    """rfft's even/odd packing assumes a real signal; complex input must
    raise on EVERY impl (xla already did; matmul silently computed
    garbage pre-fix)."""
    z = jnp.ones(16, jnp.complex64)
    for impl in ("matmul", "xla", "radix2", "auto"):
        with pytest.raises(ValueError, match="real-valued"):
            fft_ops.rfft(z, impl=impl)
