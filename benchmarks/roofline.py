#!/usr/bin/env python
"""FFT roofline harness (BASELINE.json:2,5): time, achieved device-memory
bandwidth and roofline share of each FFT impl, per transform kind.

Batched small-N FFTs are memory-bound: the speed-of-light time moves each
input and output element through device memory once
(utils/metrics.fft_roofline_bytes).  Shares are given against the
published bandwidth of the card (utils/metrics.PEAKS, keyed by
``device_kind``; an unknown card is an error) and against the bandwidth a
large elementwise copy reaches in the same process.  Each timed call ends
in ``block_until_ready``; the first call compiles and is not timed.

Usage: python benchmarks/roofline.py [--impls xla,matmul] [--kinds fft,rfft]
       [--batch 65536] [--sizes 1024,4096] [--json]
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np

from tools import common

KINDS = ("fft", "ifft", "rfft", "irfft")


def _best_time(fn, x, iters: int, reps: int = 3) -> float:
    import jax

    jax.block_until_ready(fn(x))  # compile + warm
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(x))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def fft_input(kind: str, batch: int, n: int):
    """Device input of one transform: complex64 (batch, n) for fft/ifft,
    float32 (batch, n) for rfft, complex64 (batch, n/2+1) for irfft."""
    import jax
    import jax.numpy as jnp

    kr, ki = jax.random.split(jax.random.key(0))
    if kind == "rfft":
        return jax.random.normal(kr, (batch, n), jnp.float32)
    m = n // 2 + 1 if kind == "irfft" else n
    return jax.lax.complex(jax.random.normal(kr, (batch, m), jnp.float32),
                           jax.random.normal(ki, (batch, m), jnp.float32))


def fft_bytes(kind: str, batch: int, n: int) -> int:
    """Bytes one transform must read and write at f32 precision."""
    if kind in ("fft", "ifft"):
        return 2 * batch * n * 8
    return batch * n * 4 + batch * (n // 2 + 1) * 8


def bench_fft(impl: str, kind: str, batch: int, n: int, iters: int = 20):
    """(seconds per call, GB/s) of one batched transform."""
    import jax

    from audiosignalprocess_tpu.ops import fft as fft_ops

    op = {"fft": lambda v: fft_ops.fft(v, impl=impl),
          "ifft": lambda v: fft_ops.ifft(v, impl=impl),
          "rfft": lambda v: fft_ops.rfft(v, impl=impl),
          "irfft": lambda v: fft_ops.irfft(v, n, impl=impl)}[kind]
    dt = _best_time(jax.jit(op), fft_input(kind, batch, n), iters)
    return dt, fft_bytes(kind, batch, n) / dt / 1e9


def copy_gbps(iters: int = 20) -> float:
    """Bandwidth of a large elementwise pass (read + write 2 GiB)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((1 << 29,), jnp.float32)
    dt = _best_time(jax.jit(lambda v: v * 0.999999 + 1e-9), x, iters)
    return 2 * x.size * 4 / dt / 1e9


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--impls", default="xla,matmul")
    p.add_argument("--kinds", default=",".join(KINDS))
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--sizes", default="1024,4096")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    common.require_gpu()
    from audiosignalprocess_tpu.utils.metrics import device_spec

    spec = device_spec()
    meas = copy_gbps()
    head = {"device": common.device_record(),
            "card": common.gpu_name_and_power_limit(),
            "spec_gbps": spec.hbm_gbps, "copy_gbps": round(meas, 1)}
    print(json.dumps(head) if args.json else head, flush=True)
    for impl in args.impls.split(","):
        for kind in args.kinds.split(","):
            for n in map(int, args.sizes.split(",")):
                dt, gbps = bench_fft(impl, kind, args.batch, n)
                r = dict(impl=impl, kind=kind, n=n, batch=args.batch,
                         ms=round(dt * 1e3, 4), gbps=round(gbps, 1),
                         roofline_share=round(gbps / spec.hbm_gbps, 3),
                         copy_share=round(gbps / meas, 3))
                print(json.dumps(r) if args.json else r, flush=True)


if __name__ == "__main__":
    main()
