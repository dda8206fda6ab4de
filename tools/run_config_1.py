#!/usr/bin/env python
"""Config 1 (BASELINE.json:7): mono 16 kHz WAV -> 1024-pt FFT + 64-tap FIR
lowpass via overlap-save -> WAV, CPU reference parity (SURVEY.md §3.1)."""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import design_fir
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.utils.validate import check
from tools.common import load_or_make, maybe_write, report, snr_db, std_parser, timed

RATE = 16000


def main(argv=None) -> dict:
    args = std_parser(__doc__).parse_args(argv)
    x = load_or_make(args, channels=1, rate=RATE)
    h = design_fir(64, 0.25, window_kind="hann")

    fn = jax.jit(lambda v: overlap_save(v, h, 1024))
    out, dt = timed(fn, x) if args.bench else (fn(x), None)
    out = np.asarray(out)

    snr = None
    if True:  # config 1 is the parity config: always check
        ref = oracle.overlap_save(x[0].astype(np.float64), h, 1024)
        check(out.shape == (1, ref.shape[0]), "structural mismatch")
        snr = snr_db(ref, out[0])
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    return report("config1_mono_fir_overlap_save", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
