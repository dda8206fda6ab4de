"""Benchmark: input samples/s on one GPU through the 48 kHz FIR + STFT
noise-gate chain (the primary metric, BASELINE.json:2).

Runs the chain (64-tap FIR by overlap-save, 1024/256 STFT noise gate) on
64 channels x 10 s at 48 kHz, whole-file (``chain``, the default) or
block-streamed through ``Chain.stream`` (``stream``, 4096-sample
blocks).  Prints the card's ``name, power.limit`` on one line, then ONE
JSON line::

    {"metric": "...", "value": N, "unit": "samples/s", "vs_baseline": N,
     "device": {...}}

Each timed call ends in ``block_until_ready``; the first call compiles
and is not timed.  ``vs_baseline`` is value / 48000: how many real-time
48 kHz channels one card sustains (the reference publishes no numbers,
BASELINE.json:13).  Exits non-zero when JAX finds no GPU.

Usage: python bench.py [chain|stream]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from tools import common

MODES = ("chain", "stream")


def build(mode: str):
    from audiosignalprocess_tpu.cpu_ref import oracle
    from audiosignalprocess_tpu.pipeline import Chain, FIRStage, GateStage

    chain = Chain([FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
                   GateStage(nfft=1024, hop=256, noise_frames=8)])
    chain.build()
    if mode == "chain":
        return chain.full, 256
    block = 4096
    return (lambda v: chain.stream(v, block)), block


def bench(mode: str = "chain", channels: int = 64, seconds: float = 10.0,
          fs: int = 48000, iters: int = 10) -> float:
    """Input samples/s of ``mode`` (mean over ``iters`` timed calls)."""
    import jax
    import jax.numpy as jnp

    fn, quantum = build(mode)
    n = (int(seconds * fs) // quantum) * quantum
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((channels, n)).astype(np.float32))
    step = jax.jit(fn)
    y = jax.block_until_ready(step(x))  # compile + warm
    common.check(bool(np.isfinite(np.asarray(y[:, :4096])).all()),
                 "non-finite output")
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(step(x))
    dt = (time.perf_counter() - t0) / iters
    return channels * n / dt


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "chain"
    common.check(mode in MODES, f"unknown bench mode {mode!r}: {MODES}")
    common.require_gpu()
    print(common.gpu_name_and_power_limit(), flush=True)
    sps = bench(mode)
    print(json.dumps({
        "metric": f"samples_per_s_48k_fir_stft_{mode}",
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / 48000, 2),
        "device": common.device_record(),
    }))


if __name__ == "__main__":
    main()
