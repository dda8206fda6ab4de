"""Randomized-parameter sweeps across overlap-save, the noise gate, the
resampler and the envelope-folded composite stage (seeded, so
deterministic in CI): random tap counts, FFT sizes, hops, lengths, and
batch shapes, all oracle-checked."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.effects.noise_gate import noise_gate
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.ops.resample import resample_poly

def _cases_os(k):
    rng = np.random.default_rng(2026)
    out = []
    for i in range(k):
        nfft = int(2 ** rng.integers(8, 13))
        # full legal tap range (up to nfft-1), incl. taps > nfft/2,
        # taps=1, and n < nfft
        hi = nfft // 2 if i % 2 == 0 else nfft
        taps = int(rng.integers(1, max(3, hi)))
        n = int(rng.integers(1 if i % 3 else nfft, 6 * nfft))
        b = int(rng.integers(1, 5))
        out.append((taps, nfft, n, b))
    return out


@pytest.mark.parametrize("taps,nfft,n,b", _cases_os(8))
def test_overlap_save_fuzz(taps, nfft, n, b):
    rng = np.random.default_rng(taps * 1000 + n)
    x = rng.standard_normal((b, n))
    h = rng.standard_normal(taps)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(b)])
    out = np.asarray(overlap_save(x, h, nfft))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


def _cases_gate(k):
    rng = np.random.default_rng(2027)
    out = []
    combos = [(256, 128), (512, 128), (512, 256), (1024, 256),
              (1024, 512), (2048, 512)]
    for _ in range(k):
        nfft, hop = combos[rng.integers(0, len(combos))]
        nf = int(rng.integers(24, 80))
        n = nfft + (nf - 1) * hop + int(rng.integers(0, hop))
        out.append((nfft, hop, n))
    return out


@pytest.mark.parametrize("nfft,hop,n", _cases_gate(6))
def test_gate_fuzz(nfft, hop, n):
    rng = np.random.default_rng(nfft + n)
    x = 0.01 * rng.standard_normal((2, n))
    lo, hi = n // 3, 2 * (n // 3)
    x[:, lo:hi] += np.sin(np.arange(hi - lo))
    ref = np.stack([oracle.noise_gate(x[c], nfft=nfft, hop=hop) for c in range(2)])
    out = np.asarray(noise_gate(x, nfft=nfft, hop=hop))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-9)


def _cases_rs(k):
    rng = np.random.default_rng(2028)
    out = []
    for _ in range(k):
        up = int(rng.integers(1, 24))
        down = int(rng.integers(1, 24))
        if up == down:
            down += 1
        # ragged tails on purpose: n NOT a multiple of down exercises the
        # partial final polyphase cycle (nout = ceil(n*up/down))
        n = int(rng.integers(40, 120)) * down + int(rng.integers(0, down))
        out.append((up, down, n))
    return out


@pytest.mark.parametrize("zp", (True, False), ids=("zero_phase", "causal"))
@pytest.mark.parametrize("up,down,n", _cases_rs(8))
def test_resample_fuzz(up, down, n, zp):
    rng = np.random.default_rng(up * 100 + down)
    x = rng.standard_normal((2, n))
    ref = np.stack([
        oracle.resample_poly(x[i], up, down, zero_phase=zp) for i in range(2)
    ])
    out = np.asarray(resample_poly(x, up, down, zero_phase=zp))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


def _cases_env(k):
    """Random envelope tap counts, including a single tap and counts
    around powers of two and past nfft/2."""
    rng = np.random.default_rng(2029)
    out = []
    edge = [2, 128, 129, 257, 897, 898, 1]  # around row/geometry bounds
    for i in range(k):
        te = edge[i] if i < len(edge) else int(rng.integers(2, 500))
        out.append(te)
    return out


@pytest.mark.parametrize("env_taps", _cases_env(7))
def test_env_fold_fuzz(env_taps):
    """FIRGateStage(env_h) streaming == the composed FIRStage -> GateStage
    -> EnvelopeStage stream for random env tap counts, and its carry is
    exactly those three stages' carries."""
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage,
    )

    rng = np.random.default_rng(env_taps + 7)
    block = 1024
    n = block * 4
    x = (0.01 * rng.standard_normal((2, n))).astype(np.float32)
    x[:, n // 3 : 2 * n // 3] += np.sin(np.arange(n // 3)).astype(np.float32)
    h = oracle.design_fir(64, 0.3)
    # tiny tap counts are invalid windowed-sinc designs; raw taps are fine
    he = oracle.design_fir(env_taps, 0.05) if env_taps >= 8 else \
        rng.standard_normal(env_taps)
    st = FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4, env_h=he)
    chain = Chain([st])
    lat = chain.build()
    ref_chain = Chain([FIRStage(h=h, nfft=1024),
                       GateStage(nfft=1024, hop=256, noise_frames=4),
                       EnvelopeStage(he)])
    assert ref_chain.build() == lat
    got = np.asarray(jax.jit(lambda v: chain.stream(v, block))(x))
    ref = np.asarray(jax.jit(lambda v: ref_chain.stream(v, block))(x))
    assert got.shape == ref.shape
    assert oracle.snr_db(ref + 1e-30, got + 1e-30) >= 80.0
    state = st.init_state((2,), block, jnp.float32)
    assert isinstance(state, list) and len(state) == 3
    assert state[2].shape == (2, env_taps - 1)
