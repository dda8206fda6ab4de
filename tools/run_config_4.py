#!/usr/bin/env python
"""Config 4 (BASELINE.json:10): 64-channel 96 kHz long FIR (4096-tap)
overlap-save with halo exchange over a (channel, time) mesh
(SURVEY.md §3.3).  Runs across however many devices/hosts are up —
2-host execution via tools/launch_multihost.py."""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import design_fir
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.parallel.launch import initialize
from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
from audiosignalprocess_tpu.parallel.sharded import sharded_overlap_save
from audiosignalprocess_tpu.utils.validate import check
from tools.common import load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host

RATE = 96000
CHANNELS = 64
TAPS = 4096
NFFT = 16384


def main(argv=None) -> dict:
    p = std_parser(__doc__)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    initialize(args.coordinator, args.num_processes, args.process_id)

    x = load_or_make(args, channels=CHANNELS, rate=RATE)
    h = design_fir(TAPS, 0.1, window_kind="blackman")

    ndev = len(jax.devices())
    # channel-major mesh; put leftover factor on time for the halo path
    ch = 1
    for c in (8, 4, 2, 1):
        if ndev % c == 0 and CHANNELS % c == 0:
            ch = c
            break
    tm = ndev // ch
    blk = (x.shape[-1] // (tm * 256)) * (tm * 256)
    x = x[:, :blk]

    if ndev > 1:
        mesh = make_mesh(channel=ch, time=tm)
        fn = sharded_overlap_save(mesh, h, NFFT)
        xs = shard_audio(x, mesh)
    else:
        fn = jax.jit(lambda v: overlap_save(v, h, NFFT))
        xs = x

    out, dt = timed(fn, xs) if args.bench else (fn(xs), None)
    out = to_host(out)

    snr = None
    if args.check:
        ref = np.stack([
            oracle.fir_direct(x[c].astype(np.float64), h) for c in range(4)
        ])
        snr = snr_db(ref, out[:4])
        check(out.shape == x.shape, "structural mismatch")
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    return report(f"config4_64ch_4096tap_halo_{ch}x{tm}", x, out, dt, snr,
                  args)


if __name__ == "__main__":
    main()
