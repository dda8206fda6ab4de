#!/usr/bin/env python
"""Config 3 (BASELINE.json:9): 8-channel 48 kHz STFT (1024/256) spectral
noise gate + ISTFT, channel-sharded on 1 host (SURVEY.md §3.2)."""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
from audiosignalprocess_tpu.parallel.sharded import sharded_noise_gate
from audiosignalprocess_tpu.pipeline import Chain, GateStage
from audiosignalprocess_tpu.utils.validate import check
from tools.common import load_or_make, maybe_write, report, snr_db, std_parser, timed

RATE = 48000


def main(argv=None) -> dict:
    args = std_parser(__doc__).parse_args(argv)
    x = load_or_make(args, channels=8, rate=RATE)
    n = (x.shape[-1] // 256) * 256
    x = x[:, :n]

    ndev = len(jax.devices())
    ch = min(8, ndev)
    if ch > 1:
        mesh = make_mesh(channel=ch, time=1)
        fn = sharded_noise_gate(mesh)
        xs = shard_audio(x, mesh)
    else:  # single device: same math, unsharded
        g = Chain([GateStage()])
        g.build()
        fn = jax.jit(g.full)
        xs = x

    out, dt = timed(fn, xs) if args.bench else (fn(xs), None)
    out = np.asarray(out)

    snr = None
    if args.check:
        ref = np.stack([oracle.noise_gate(x[c].astype(np.float64)) for c in range(8)])
        got = out[:, : ref.shape[-1]]
        check(np.allclose(out[:, ref.shape[-1]:], 0.0, atol=1e-6), "tail not zero")
        snr = snr_db(ref, got)
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    return report(f"config3_8ch_noise_gate_{ch}dev", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
