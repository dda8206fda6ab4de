#!/usr/bin/env python
"""Multi-host launcher (SURVEY.md §2 P7): spawn one process per host for a
config driver, wiring the jax.distributed control plane.

On real hosts each runs its own process, given the coordinator's address;
locally, ``--simulate N`` forks N CPU processes with
xla_force_host_platform_device_count so the full multi-process collective
path (jax.distributed control plane + per-process device mesh) is
exercised without accelerators.

Usage:
    python tools/launch_multihost.py --simulate 2 -- tools/run_config_4.py --check
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check(cond, msg):
    """-O-safe guard (mirrors utils.validate.check).  Local copy keeps
    the launcher import-free of the jax-loading library package: the
    child processes need their platform env set BEFORE jax initializes,
    and the parent has no reason to pay (or risk) a backend init."""
    if not cond:
        raise ValueError(msg)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--simulate", type=int, default=2,
                   help="number of simulated host processes")
    p.add_argument("--devices-per-host", type=int, default=4)
    p.add_argument("--port", type=int, default=9811)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- script.py [args...]")
    args = p.parse_args()
    cmd = [c for c in args.cmd if c != "--"]
    check(cmd, "pass the driver script after --")

    procs = []
    for pid in range(args.simulate):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices_per_host}"
        ).strip()
        full = [
            sys.executable, cmd[0],
            "--coordinator", f"localhost:{args.port}",
            "--num-processes", str(args.simulate),
            "--process-id", str(pid),
            *cmd[1:],
        ]
        procs.append(subprocess.Popen(full, env=env))
    rc = 0
    for pr in procs:
        rc |= pr.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
