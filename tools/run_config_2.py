#!/usr/bin/env python
"""Config 2 (BASELINE.json:8): stereo 44.1 kHz -> polyphase resample to
48 kHz (160/147) + 256-tap bandpass, single chip."""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu.ops.resample import resample_poly
from audiosignalprocess_tpu.utils.validate import check
from tools.common import load_or_make, maybe_write, report, snr_db, std_parser, timed

RATE_IN, RATE_OUT = 44100, 48000


def main(argv=None) -> dict:
    args = std_parser(__doc__).parse_args(argv)
    x = load_or_make(args, channels=2, rate=RATE_IN, kind="am")
    h_bp = design_fir(256, (0.1, 0.5), window_kind="hamming", pass_zero=False)

    def chain(v):
        return fir_direct(resample_poly(v, 160, 147), h_bp)

    fn = jax.jit(chain)
    out, dt = timed(fn, x) if args.bench else (fn(x), None)
    out = np.asarray(out)

    snr = None
    if args.check:
        ref = np.stack([
            oracle.fir_direct(oracle.resample_poly(x[c].astype(np.float64), 160, 147), h_bp)
            for c in range(2)
        ])
        check(out.shape == ref.shape, "structural mismatch")
        snr = snr_db(ref, out)
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE_OUT)
    return report("config2_stereo_resample_bandpass", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
