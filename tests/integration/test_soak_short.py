"""Short-soak regression guards at CI-affordable lengths:

1. the vocoder stream's SNR vs the f64 oracle stays high over 32 drained
   blocks (the rotor phase accumulator is the long-stream risk), and
2. the composite chain's drained long-stream profile stays flat (its
   carries are FIFO tails — any slope is a new accumulating error).
"""

import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle


def test_stretch_soak_short_pinned_analysis():
    """32 drained f32 vocoder blocks track the f64 oracle at >= 95 dB."""
    import jax

    from audiosignalprocess_tpu.pipeline import Chain, StretchStage

    block, nblocks = 2048, 32
    n = block * nblocks
    rng = np.random.default_rng(11)
    t = np.arange(n) / 48000.0
    x = (0.3 * rng.standard_normal((2, n))
         + 0.5 * np.sin(2 * np.pi * 440.0 * t)
         * np.sin(2 * np.pi * 0.3 * t)).astype(np.float32)
    cf = Chain([StretchStage(p=4, q=3, nfft=1024, hop=256)])
    cf.build()
    y = np.asarray(jax.jit(lambda v: cf.stream(v, block, drain=True))(x))
    ref = np.stack([
        oracle.time_stretch(x[i].astype(np.float64), 4 / 3, 1024, 256)
        for i in range(2)
    ])
    m = min(y.shape[-1], ref.shape[-1]) - 2048
    snr = oracle.snr_db(ref[:, :m], y[:, :m].astype(np.float64))
    assert snr >= 95.0, snr


def test_composite_soak_short_flat():
    """24 drained composite blocks: overall >= 60 dB with margin AND the
    last quarter's segment SNR within 15 dB of the second quarter's (a
    flat profile — the composite has no cross-block recursion; a slope
    would be a new accumulating carry error).  The first quarter holds
    the burst onset (a localized, understood dip) and is excluded."""
    import jax

    from audiosignalprocess_tpu.pipeline import Chain, ResFIRGateStage

    b_in, nblocks = 2 * 588, 24
    n = b_in * nblocks
    h = oracle.design_fir(64, 0.3)
    he = oracle.design_fir(129, 0.05)
    rng = np.random.default_rng(11)
    x = (0.01 * rng.standard_normal((2, n))).astype(np.float32)
    lo, hi = n // 8, n // 4
    x[:, lo:hi] += np.sin(
        2 * np.pi * 440 * np.arange(hi - lo) / 44100).astype(np.float32)
    chain = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024,
                                   hop=256, noise_frames=4, env_h=he)])
    chain.build()
    y = np.asarray(jax.jit(lambda v: chain.stream(v, b_in, drain=True))(x))
    base = np.stack([
        oracle.noise_gate(
            oracle.fir_direct(
                oracle.resample_poly(x[i].astype(np.float64), 160, 147,
                                     zero_phase=False), h),
            noise_frames=4) for i in range(2)
    ])
    ref = np.stack([
        oracle.fir_direct(np.abs(base[i]), he) * (np.pi / 2.0)
        for i in range(2)
    ])
    m = min(y.shape[-1], ref.shape[-1])
    q = m // 4
    snr_all = oracle.snr_db(ref[:, :m], y[:, :m].astype(np.float64))
    snr_q2 = oracle.snr_db(ref[:, q:2 * q], y[:, q:2 * q].astype(np.float64))
    snr_q4 = oracle.snr_db(ref[:, 3 * q:m], y[:, 3 * q:m].astype(np.float64))
    assert snr_all >= 60.0, snr_all
    assert snr_q4 >= snr_q2 - 15.0, (snr_q2, snr_q4)
