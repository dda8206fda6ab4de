#!/usr/bin/env python
"""Pipeline stage-overlap experiment (SURVEY.md §2 P5).

The surveyed design asks whether a double-buffered stage pipeline —
stage s processing block k while stage s+1 processes block k-1 — beats
the sequential per-block stage loop of ``Chain.stream``.

Variant A (sequential): lax.scan whose body runs stage1 then stage2 on
the SAME block — stage2 data-depends on stage1, so XLA must serialize
them within the step.

Variant B (skewed): the same scan, but stage2 consumes stage1's output
of the PREVIOUS block (carried).  Same total work and identical output
stream (delayed one block); the two stages of one step are now
data-independent, so XLA's scheduler is free to run stage1's FFT work
beside stage2's elementwise work.

The skew can only help to the extent the scheduler finds concurrency it
could not find inside the serialized step.  Measuring both (each call
ends in ``block_until_ready``) answers the survey question empirically;
the parity check pins that the skewed stream equals the sequential one
shifted by one block.

Usage: python benchmarks/stage_overlap.py [--json] [--channels 64]
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import common  # noqa: E402  (sets the compile cache)

from audiosignalprocess_tpu.utils.validate import check

import argparse
import json
import time

import numpy as np


def build(channels, block, n):
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.cpu_ref import oracle
    from audiosignalprocess_tpu.pipeline import Chain, FIRStage, GateStage

    chain = Chain([
        FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
        GateStage(nfft=1024, hop=256, noise_frames=8),
    ])
    chain.build()

    # the skew feeds stage 2 one block of zeros first: that is INPUT
    # LATENCY from stage 2's point of view — a separately-configured
    # stage pair makes the delayed stream exactly equal the sequential one
    s1 = FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024)
    s2 = GateStage(nfft=1024, hop=256, noise_frames=8)
    lat1 = s1.configure(0)
    s2.configure(lat1 + s1.out_block(block))

    def seq_stream(x):
        return chain.stream(x, block)

    def skewed_stream(x):
        nb = x.shape[-1] // block
        st1 = s1.init_state(x.shape[:-1], block, x.dtype)
        st2 = s2.init_state(x.shape[:-1], s1.out_block(block), x.dtype)
        buf = jnp.zeros(x.shape[:-1] + (s1.out_block(block),), x.dtype)
        blocks = jnp.moveaxis(
            x.reshape(x.shape[:-1] + (nb, block)), -2, 0)

        def body(carry, xb):
            c1, c2, b_prev = carry
            c2, y = s2.step(c2, b_prev)   # block k-1 through stage 2
            c1, b_cur = s1.step(c1, xb)   # block k through stage 1
            return (c1, c2, b_cur), y

        _, ys = jax.lax.scan(body, (st1, st2, buf), blocks)
        return jnp.moveaxis(ys, 0, -2).reshape(x.shape[:-1] + (-1,))

    return seq_stream, skewed_stream, chain


def measure(fn, x, iters=8):
    import jax

    step = jax.jit(fn)
    jax.block_until_ready(step(x))  # compile + warm
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(step(x))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.parallel.launch import initialize

    initialize()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--blocks", type=int, default=32)
    p.add_argument("--json", action="store_true")
    args = p.parse_args()

    n = args.block * args.blocks
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((args.channels, n)).astype(np.float32))
    seq, skew, chain = build(args.channels, args.block, n)

    # parity: skewed == sequential shifted one block
    a = np.asarray(jax.jit(seq)(x))
    b = np.asarray(jax.jit(skew)(x))
    shift = chain.stages[0].out_block(args.block)
    err = np.max(np.abs(b[..., shift:] - a[..., : a.shape[-1] - shift]))
    check(err < 1e-4, f"skewed stream diverges: {err}")

    t_seq = measure(seq, x)
    t_skew = measure(skew, x)
    rec = dict(device=common.device_record(), channels=args.channels,
               block=args.block, blocks=args.blocks,
               seq_ms=round(t_seq * 1e3, 3), skewed_ms=round(t_skew * 1e3, 3),
               speedup=round(t_seq / t_skew, 3), parity_max_err=float(err))
    print(json.dumps(rec) if args.json else rec, flush=True)


if __name__ == "__main__":
    main()
