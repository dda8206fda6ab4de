"""Resample+FIR+gate composite stage (ResFIRGateStage) vs the oracle
chain and vs its composed sub-stages."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.pipeline import ResFIRGateStage


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(53)


def _mk(rng, c, n, fs=44100):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.2 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _oracle_chain(x, up, down, h, **kw):
    y = oracle.resample_poly(x, up, down, zero_phase=False)
    return oracle.noise_gate(oracle.fir_direct(y, h), **kw)


def resample_fir_gate(x, up, down, h, noise_frames=8, release=0.0):
    """ResFIRGateStage.full cut to the gate's synthesis length (the stage
    zero-pads back to the resampled length; the pad must be zero)."""
    y = np.asarray(ResFIRGateStage(up=up, down=down, h=h, nfft=1024,
                                   hop=256, noise_frames=noise_frames,
                                   release=release).full(x))
    n_rs = -(-x.shape[-1] * up // down)
    n = 1024 + ((n_rs - 1024) // 256) * 256
    assert y.shape[-1] == n_rs and not y[..., n:].any()
    return y[..., :n]


def test_vs_oracle_f64(rng):
    up, down = 160, 147
    n = 147 * 160 * 2
    x = _mk(rng, 2, n)
    h = oracle.design_fir(64, 0.3)
    out = resample_fir_gate(x, up, down, h, noise_frames=4)
    ref = np.stack([_oracle_chain(x[c], up, down, h, noise_frames=4)
                    for c in range(2)])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_f32_snr(rng):
    up, down = 160, 147
    n = 147 * 160 * 2
    x = _mk(rng, 2, n).astype(np.float32)
    h = oracle.design_fir(64, 0.3)
    out = resample_fir_gate(x, up, down, h, noise_frames=4)
    ref = np.stack([_oracle_chain(x[c].astype(np.float64), up, down, h,
                                  noise_frames=4) for c in range(2)])
    assert oracle.snr_db(ref, out.astype(np.float64)) >= 60.0


def test_release_and_simple_ratio(rng):
    """2:1 ratio + release smoothing."""
    up, down = 2, 1
    n = 16384
    x = _mk(rng, 2, n, fs=24000)
    h = oracle.design_fir(96, 0.25)
    out = resample_fir_gate(x, up, down, h, noise_frames=4, release=0.7)
    ref = np.stack([_oracle_chain(x[c], up, down, h, noise_frames=4,
                                  release=0.7) for c in range(2)])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)


def test_long_fir(rng):
    """A long FIR (384 taps) behind the resampler."""
    up, down = 160, 147
    n = 147 * 160 * 2
    x = _mk(rng, 1, n)
    h = oracle.design_fir(384, 0.2)
    out = resample_fir_gate(x, up, down, h, noise_frames=4)
    ref = _oracle_chain(x[0], up, down, h, noise_frames=4)
    np.testing.assert_allclose(out[0], ref, rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# streaming step (ResFIRGateStage.step)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_step_vs_composed_stages(rng, release):
    """ResFIRGateStage.step, block by block == ResampleStage.step ->
    FIRGateStage.step over multiple blocks (raw block, carries in both
    domains)."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import (
        Chain, FIRGateStage, ResampleStage,
    )

    up, down, nfft, hop = 160, 147, 1024, 256
    h = oracle.design_fir(64, 0.3)
    b_in = 4 * 588
    nblocks = 5
    x = _mk(rng, 2, b_in * nblocks).astype(np.float32)

    fg = FIRGateStage(h=h, nfft=nfft, hop=hop, noise_frames=4,
                      release=release)
    chain = Chain([ResampleStage(up=up, down=down), fg])
    chain.build()
    ref = np.asarray(chain.stream(jnp.asarray(x), b_in))

    st = ResFIRGateStage(up=up, down=down, h=h, nfft=nfft, hop=hop,
                         noise_frames=4, release=release)
    Chain([st]).build()
    state = st.init_state((2,), b_in, jnp.float32)
    outs = []
    for k in range(nblocks):
        state, y = st.step(state, jnp.asarray(x[:, k * b_in : (k + 1) * b_in]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)
    assert got.shape == ref.shape
    assert oracle.snr_db(ref + 1e-30, got + 1e-30) >= 80.0


def test_res_stage_stream_equals_full(rng):
    """ResFIRGateStage: stream[lat:] == full == composed full."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import (
        Chain, FIRGateStage, ResampleStage, ResFIRGateStage,
    )

    h = oracle.design_fir(64, 0.3)
    b_in = 4 * 588
    x = _mk(rng, 2, b_in * 5).astype(np.float32)
    st = ResFIRGateStage(up=160, down=147, h=h, nfft=1024, hop=256,
                         noise_frames=4)
    chain = Chain([st])
    lat = chain.build()
    full = np.asarray(chain.full(jnp.asarray(x)))
    stream = np.asarray(chain.stream(jnp.asarray(x), b_in))
    ref_chain = Chain([ResampleStage(up=160, down=147),
                       FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4)])
    assert ref_chain.build() == lat
    ref_full = np.asarray(ref_chain.full(jnp.asarray(x)))
    m = min(full.shape[-1], ref_full.shape[-1])
    assert oracle.snr_db(ref_full[:, :m] + 1e-30, full[:, :m] + 1e-30) >= 100.0
    got = stream[:, lat:]
    end = min(got.shape[-1], full.shape[-1])
    assert oracle.snr_db(full[:, :end] + 1e-30, got[:, :end] + 1e-30) >= 80.0


def test_res_stage_env_one_kernel_step(rng):
    """env_h appends the envelope demod: the ENTIRE config-5 chain
    (resample -> FIR -> gate -> envelope) as one stage == the four
    separate stages composed, streamed and whole-file."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import (
        Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage,
        ResFIRGateStage,
    )

    h = oracle.design_fir(64, 0.3)
    he = oracle.design_fir(129, 0.05)
    b_in = 4 * 588
    x = _mk(rng, 2, b_in * 5).astype(np.float32)
    st = ResFIRGateStage(up=160, down=147, h=h, nfft=1024, hop=256,
                         noise_frames=4, env_h=he)
    state = st.init_state((2,), b_in, jnp.float32)
    assert isinstance(state, list) and len(state[1]) == 3  # env carry
    chain = Chain([st])
    lat = chain.build()
    ref_chain = Chain([ResampleStage(up=160, down=147),
                       FIRStage(h=h, nfft=1024),
                       GateStage(nfft=1024, hop=256, noise_frames=4),
                       EnvelopeStage(he)])
    assert ref_chain.build() == lat
    got = np.asarray(chain.stream(jnp.asarray(x), b_in))
    ref = np.asarray(ref_chain.stream(jnp.asarray(x), b_in))
    assert got.shape == ref.shape
    assert oracle.snr_db(ref + 1e-30, got + 1e-30) >= 80.0
    full = np.asarray(chain.full(jnp.asarray(x)))
    ref_full = np.asarray(ref_chain.full(jnp.asarray(x)))
    m = min(full.shape[-1], ref_full.shape[-1])
    assert oracle.snr_db(ref_full[:, :m] + 1e-30, full[:, :m] + 1e-30) >= 80.0
    s = got[:, lat:]
    end = min(s.shape[-1], full.shape[-1])
    assert oracle.snr_db(full[:, :end] + 1e-30, s[:, :end] + 1e-30) >= 80.0


def test_res_stage_fallback_f64(rng):
    """f64 streams through the same composed two-state step, to the f64
    streaming bound."""
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import Chain, ResFIRGateStage

    h = oracle.design_fir(64, 0.3)
    st = ResFIRGateStage(up=160, down=147, h=h, nfft=1024, hop=256,
                         noise_frames=4)
    chain = Chain([st])
    lat = chain.build()
    b_in = 4 * 588
    x = _mk(rng, 1, b_in * 5)  # float64
    state = st.init_state((1,), b_in, jnp.float64)
    assert isinstance(state, list)  # composed fallback
    full = np.asarray(chain.full(jnp.asarray(x)))
    stream = np.asarray(chain.stream(jnp.asarray(x), b_in))
    got = stream[:, lat:]
    end = min(got.shape[-1], full.shape[-1])
    assert oracle.snr_db(full[:, :end] + 1e-30, got[:, :end] + 1e-30) >= 100.0
