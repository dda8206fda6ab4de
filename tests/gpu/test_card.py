"""Tests that need an NVIDIA GPU (marker ``gpu``; skip elsewhere).

Run on a machine with a card: ``python -m pytest -m gpu tests/`` (or as
phase 5 of ``python chip_smoke.py``).  They pin what only the card can
show: the FFT route XLA takes there, that every f32 matmul/convolution on
the path runs at full f32 precision rather than TF32 (TF32 keeps ~10
mantissa bits: ~60 dB at best, so the >= 100 dB bounds below separate the
two), and that the peak table knows the card.
"""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle

pytestmark = pytest.mark.gpu

F32_MIN_DB = 100.0


def _snr(ref, test):
    ref = np.asarray(ref, np.complex128)
    err = ref - np.asarray(test, np.complex128)
    return 10.0 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(err) ** 2))


@pytest.mark.parametrize("impl", ("auto", "matmul"))
@pytest.mark.parametrize("n", (1024, 4096))
def test_fft_f32_on_card(gpu_device, impl, n):
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.ops import fft as fft_ops

    x = np.random.default_rng(n).standard_normal((256, n)).astype(np.float32)
    xd = jax.device_put(jnp.asarray(x), gpu_device)
    spec = jax.jit(lambda v: fft_ops.rfft(v, impl=impl))(xd)
    assert _snr(np.fft.rfft(x.astype(np.float64)), spec) >= F32_MIN_DB
    back = jax.jit(lambda s: fft_ops.irfft(s, n, impl=impl))(spec)
    assert _snr(x.astype(np.float64), back) >= F32_MIN_DB


def test_fir_and_resample_full_f32(gpu_device):
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.ops.fir import fir_direct
    from audiosignalprocess_tpu.ops.resample import resample_poly

    x = np.random.default_rng(3).standard_normal((4, 14700)).astype(np.float32)
    xd = jax.device_put(jnp.asarray(x), gpu_device)
    h = oracle.design_fir(256, 0.2)
    y = jax.jit(lambda v: fir_direct(v, h))(xd)
    ref = np.stack([oracle.fir_direct(r.astype(np.float64), h) for r in x])
    assert _snr(ref, y) >= F32_MIN_DB
    y = jax.jit(lambda v: resample_poly(v, 160, 147, zero_phase=False))(xd)
    ref = np.stack([oracle.resample_poly(r.astype(np.float64), 160, 147,
                                         zero_phase=False) for r in x])
    assert _snr(ref, y) >= F32_MIN_DB


def test_peak_table_knows_card(gpu_device):
    from audiosignalprocess_tpu.utils.metrics import device_spec

    spec = device_spec(gpu_device.device_kind)
    assert spec.hbm_gbps > 0 and spec.f32_tflops > 0


def test_config5_stream_equals_full_on_card(gpu_device):
    """Streaming == whole-file for the config-5 composite on the card
    (f32; 80 dB: the same arithmetic reassociated)."""
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.api import make_chain

    rng = np.random.default_rng(7)
    n = 147 * 64 * 8
    x = (0.01 * rng.standard_normal((8, n))).astype(np.float32)
    x[:, n // 4: n // 2] += np.sin(
        2 * np.pi * 440 * np.arange(n // 2 - n // 4) / 44100).astype(np.float32)
    chain = make_chain(44100, 48000, envelope_hz=240.0)
    xd = jax.device_put(jnp.asarray(x), gpu_device)
    full = np.asarray(jax.jit(chain.full_flush)(xd))
    stream = np.asarray(jax.jit(
        lambda v: chain.stream(v, 147 * 64, drain=True))(xd))
    assert full.shape == stream.shape
    assert _snr(full.astype(np.float64) + 1e-30,
                stream.astype(np.float64) + 1e-30) >= 80.0
