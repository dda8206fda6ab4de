"""FIR+gate composite stage (FIRGateStage) vs the oracle chain."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.pipeline import FIRGateStage


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(47)


def _mk(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _oracle_chain(x, h, **kw):
    return oracle.noise_gate(oracle.fir_direct(x, h), **kw)


def fir_noise_gate(x, h, noise_frames=8, release=0.0):
    """FIRGateStage.full cut to the gate's synthesis length (the stage
    zero-pads back to the input length; the pad must be zero)."""
    y = np.asarray(FIRGateStage(h=h, nfft=1024, hop=256,
                                noise_frames=noise_frames,
                                release=release).full(x))
    n = 1024 + ((x.shape[-1] - 1024) // 256) * 256
    assert not y[..., n:].any()
    return y[..., :n]


@pytest.mark.parametrize("n", (48128, 16384 + 256 * 3))
def test_vs_oracle_f64(rng, n):
    x = _mk(rng, 2, n)
    h = oracle.design_fir(64, 0.3)
    ref = np.stack([_oracle_chain(x[c], h) for c in range(2)])
    out = fir_noise_gate(x, h)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_f32_snr(rng):
    x = _mk(rng, 4, 32768).astype(np.float32)
    h = oracle.design_fir(64, 0.3)
    ref = np.stack([_oracle_chain(x[c].astype(np.float64), h) for c in range(4)])
    out = fir_noise_gate(x, h)
    assert oracle.snr_db(ref, out) >= 60.0


def test_long_taps(rng):
    x = _mk(rng, 1, 32768)
    h = oracle.design_fir(384, 0.2)
    ref = _oracle_chain(x[0], h)
    out = fir_noise_gate(x, h)[0]
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("env_taps,release", ((129, 0.0), (200, 0.6)))
def test_fir_gate_env_one_kernel_step(rng, env_taps, release):
    """env_h appends the envelope demod to the FIR+gate stage:
    FIRGateStage(env_h) streaming == FIRStage -> GateStage -> EnvelopeStage
    composed; state carries the rectified env tail; whole-file matches."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage,
    )

    h = oracle.design_fir(64, 0.3)
    he = oracle.design_fir(env_taps, 0.05)
    block = 2048
    x = _mk(rng, 2, block * 6).astype(np.float32)
    st = FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4,
                      release=release, env_h=he)
    state = st.init_state((2,), block, jnp.float32)
    assert isinstance(state, list) and state[2].shape == (2, env_taps - 1)
    chain = Chain([st])
    lat = chain.build()
    ref_chain = Chain([FIRStage(h=h, nfft=1024),
                       GateStage(nfft=1024, hop=256, noise_frames=4,
                                 release=release),
                       EnvelopeStage(he)])
    assert ref_chain.build() == lat
    got = np.asarray(chain.stream(jnp.asarray(x), block))
    ref = np.asarray(ref_chain.stream(jnp.asarray(x), block))
    assert got.shape == ref.shape
    assert oracle.snr_db(ref + 1e-30, got + 1e-30) >= 80.0
    full = np.asarray(chain.full(jnp.asarray(x)))
    ref_full = np.asarray(ref_chain.full(jnp.asarray(x)))
    assert oracle.snr_db(ref_full + 1e-30, full + 1e-30) >= 80.0


def test_env_out_of_geometry_falls_back(rng):
    """Envelope taps longer than nfft, or a single tap, stream through
    the composed [_fir, _gate, _env] carries like any other count."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import Chain, FIRGateStage

    h = oracle.design_fir(64, 0.3)
    block = 2048
    x = _mk(rng, 2, block * 4).astype(np.float32)
    for he in (oracle.design_fir(1000, 0.05), np.array([0.5])):
        st = FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4, env_h=he)
        state = st.init_state((2,), block, jnp.float32)
        assert isinstance(state, list) and len(state) == 3  # composed
        chain = Chain([st])
        chain.build()
        got = np.asarray(chain.stream(jnp.asarray(x), block))
        full = np.asarray(chain.full(jnp.asarray(x)))
        assert got.shape[-1] == x.shape[-1] and np.isfinite(full).all()


def test_release_smoothing(rng):
    """Release smoothing in the composite stage matches the oracle's
    whole-signal scan."""
    x = _mk(rng, 2, 32768)
    h = oracle.design_fir(64, 0.3)
    ref = np.stack([
        oracle.noise_gate(oracle.fir_direct(x[c], h), release=0.7)
        for c in range(2)
    ])
    out = fir_noise_gate(x, h, release=0.7)
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)
