#!/usr/bin/env python
"""Config-5 chain timings on one GPU (BASELINE.json:11): the whole-file
chain and one streaming step, at full width.

The chain is ``api.make_chain(44100, 48000, envelope_hz=240)``: resample
160/147 -> 64-tap FIR -> 1024/256 noise gate -> 129-tap envelope, on
128 channels.  Reports, per measurement, the mean of ``--iters`` timed
calls after one untimed compile call (each ends in
``block_until_ready``), input samples/s, and the card's peak bytes in
use.  Exits non-zero when JAX finds no GPU.

Usage: python benchmarks/config5.py [--seconds 30] [--iters 10] [--json]
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

from tools import common

CHANNELS = 128
BLOCK = 147 * 64


def _mean_time(fn, *args, iters: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def measure(seconds: float = 30.0, iters: int = 10,
            channels: int = CHANNELS) -> dict:
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.api import make_chain

    chain = make_chain(44100, 48000, envelope_hz=240.0)
    n = (int(seconds * 44100) // BLOCK) * BLOCK
    x = jax.random.normal(jax.random.key(0), (channels, n), jnp.float32)
    full = jax.jit(chain.full_flush)
    t_full = _mean_time(full, x, iters=iters)
    state = chain.init_state((channels,), BLOCK, jnp.float32)
    step = jax.jit(chain.step)
    xb = x[:, :BLOCK]
    t_step = _mean_time(step, state, xb, iters=10 * iters)
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "channels": channels, "samples": n, "block": BLOCK,
        "full_s": t_full, "full_samples_per_s": channels * n / t_full,
        "step_s": t_step, "step_samples_per_s": channels * BLOCK / t_step,
        "block_audio_s": BLOCK / 44100,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def device_op_times(xplane_path: str, top: int = 12) -> dict:
    """Reduce a profiler trace to the GPU's busy share of the traced
    window and its ``top`` kernels by summed device time (seconds).  The
    GPU plane (``/device:GPU:<i>``) holds one line per CUDA stream
    (``Stream #<n>(...)``) whose events are the kernels and copies: XLA
    fusions by their HLO name, library kernels (cuFFT, cuBLAS, cuDNN) by
    theirs."""
    from jax.profiler import ProfileData

    ops, spans = {}, []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns * 1e-9
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return {"busy_share": None, "top_ops": []}
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_share": busy / window, "op_seconds": sum(ops.values()),
            "top_ops": [(k[:120], round(v, 6)) for k, v in ranked]}


def trace_full(seconds: float, trace_dir: str, calls: int = 3) -> dict:
    """Trace ``calls`` warm whole-file calls; reduce with device_op_times."""
    import glob

    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.api import make_chain

    chain = make_chain(44100, 48000, envelope_hz=240.0)
    n = (int(seconds * 44100) // BLOCK) * BLOCK
    x = jax.random.normal(jax.random.key(0), (CHANNELS, n), jnp.float32)
    full = jax.jit(chain.full_flush)
    jax.block_until_ready(full(x))
    with jax.profiler.trace(trace_dir):
        for _ in range(calls):
            jax.block_until_ready(full(x))
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    return device_op_times(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also trace 3 whole-file calls into DIR and print "
                        "the GPU busy share and top ops")
    args = p.parse_args(argv)
    common.require_gpu()
    rec = {"device": common.device_record(),
           "card": common.gpu_name_and_power_limit(),
           **measure(args.seconds, args.iters)}
    print(json.dumps(rec) if args.json else rec, flush=True)
    if args.trace:
        tr = trace_full(args.seconds, args.trace)
        print(json.dumps(tr) if args.json else tr, flush=True)


if __name__ == "__main__":
    main()
