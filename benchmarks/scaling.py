#!/usr/bin/env python
"""Device scaling harness (BASELINE.json:2,5: samples/s at 1 device and
N devices, with >=90% linear scaling 1->4 as the target).

Runs the sharded config-5-style chain over (1, d) (channel, time) meshes
of d = 1, 2, 4, ... devices and reports samples/s plus scaling efficiency
vs the first size.  On a host with several GPUs this measures NCCL
collectives over NVLink; with
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``
it validates the mechanics on virtual devices (functional, not a perf
claim: every row names the platform it ran on).  Several processes:
launch one per host via tools/launch_multihost.py with ``--coordinator``.

Each timed call ends in ``block_until_ready``; the first call compiles.
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def bench_mesh(ndev: int, channels: int, per_shard: int, iters: int = 8):
    import jax

    from audiosignalprocess_tpu.cpu_ref import oracle
    from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
    from audiosignalprocess_tpu.parallel.sharded import sharded_chain
    from audiosignalprocess_tpu.pipeline import Chain, FIRStage, GateStage, ResampleStage

    chain = Chain([
        ResampleStage(up=160, down=147),
        FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
        GateStage(nfft=1024, hop=256, noise_frames=4),
    ])
    chain.build()
    mesh = make_mesh(channel=1, time=ndev)
    n = per_shard * ndev
    rng = np.random.default_rng(0)
    x = shard_audio(rng.standard_normal((channels, n)).astype(np.float32),
                    mesh)
    fn = sharded_chain(mesh, chain)
    jax.block_until_ready(fn(x))  # compile + warm
    best = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(x))
        best = min(best, (time.perf_counter() - t0) / iters)
    return channels * n / best


def main():
    import jax

    from audiosignalprocess_tpu.parallel.launch import initialize
    from tools.common import device_record

    initialize()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--per-shard", type=int, default=147 * 64)
    p.add_argument("--json", action="store_true")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--sizes", default=None,
                   help="comma list of device counts (default: powers of 2)")
    args = p.parse_args()

    ndev_all = len(jax.devices())
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",") if int(s) <= ndev_all]
    else:
        sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev_all]
    base = None
    base_nd = None
    for nd in sizes:  # print each row as it completes
        sps = bench_mesh(nd, args.channels, args.per_shard, args.iters)
        if base is None:
            base, base_nd = sps, nd
        # efficiency vs linear extrapolation FROM THE FIRST MEASURED SIZE
        # (per-device base throughput base/base_nd), so --sizes 4,8 still
        # reports a meaningful 4->8 efficiency instead of 1/nd artifacts
        eff = sps / ((base / base_nd) * nd)
        r = dict(devices=nd, samples_per_s=round(sps, 1),
                 scaling_eff=round(eff, 3), device=device_record())
        if args.json:
            print(json.dumps(r), flush=True)
        else:
            print(f"devices={r['devices']:>3}  {r['samples_per_s']/1e6:10.2f} M samples/s"
                  f"  eff={100*r['scaling_eff']:.1f}%", flush=True)


if __name__ == "__main__":
    main()
