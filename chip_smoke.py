#!/usr/bin/env python
"""On-GPU smoke test: the audio chain's main path, on the card, checked.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # only the sharded configs 3/4/5 over
                                  # four cards, vs one card and the oracle

Phases (one process; every phase that fails fails the script):

1. device  — the card's ``name, power.limit`` (nvidia-smi) and the device
   as JAX reports it.  No GPU: exit non-zero before anything else.
2. fft     — ``ops.fft`` fft/ifft/rfft/irfft through ``impl="auto"`` at
   n = 1024 and 4096 on 65536 rows, vs ``np.fft`` in float64 on a row
   subset.  Bound 100 dB: f32 FFT rounding sits near 130 dB, and TF32 or
   a wrong route would fall far below.
3. chain   — config 5 at full width: a 128-channel, 44.1 kHz, 30 s WAV
   (seeds 0 and 1) through ``api.chain_file`` whole-file and block-
   streamed (resample 160/147 -> 64-tap FIR -> noise gate -> envelope),
   4 channels vs the float64 oracle chain (>= 60 dB, the system's bound)
   and streamed vs whole-file on all channels (>= 80 dB: the two are the
   same arithmetic reassociated; only a gate bin on its hard threshold
   can move); then ``tools/run_config_5.py`` stream and ring modes with
   their own checks.  Prints the whole-file step's
   ``compiled.memory_analysis()`` and the card's peak bytes in use.
4. configs — configs 1-4 through their drivers' ``--check`` paths at the
   BASELINE widths (parity = >= 60 dB vs the oracle).
5. gpu tests — ``pytest -m gpu`` in this process (a second JAX process
   could not get the card's memory).

The last line of standard output is one JSON object, printed only when
every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from tools import common  # first: sets the compilation cache
from tools.common import check

REPO = os.path.dirname(os.path.abspath(__file__))

FFT_SIZES = (1024, 4096)
FFT_ROWS = 65536
FFT_ORACLE_ROWS = 64
FFT_MIN_DB = 100.0

RATE_IN, RATE_OUT = 44100, 48000
CHANNELS = 128
SECONDS = 30.0
BLOCK = 147 * 64  # tools/run_config_5.BLOCK: 8 input quanta of the stage
ENV_HZ = 240.0  # design_fir(129, 2*240/48000) == config 5's envelope taps
ORACLE_CHANNELS = 4
SEEDS = (0, 1)
ORACLE_MIN_DB = 60.0
STREAM_MIN_DB = 80.0

CONFIG_SECONDS = {1: 30.0, 2: 30.0, 3: 30.0, 4: 10.0}


def log(msg: str) -> None:
    print(msg, flush=True)


def _snr(ref, test) -> float:
    ref = np.asarray(ref, np.complex128)
    err = ref - np.asarray(test, np.complex128)
    e = float(np.sum(np.abs(err) ** 2))
    return np.inf if e == 0.0 else float(10.0 * np.log10(
        float(np.sum(np.abs(ref) ** 2)) / e))


# -- phase 1 ---------------------------------------------------------------


def phase_device() -> dict:
    rec = common.device_record()
    log(f"[device] jax: {rec}")
    return rec


# -- phase 2 ---------------------------------------------------------------


def phase_fft(sizes=FFT_SIZES, rows=FFT_ROWS, oracle_rows=FFT_ORACLE_ROWS,
              min_db=FFT_MIN_DB) -> list:
    """Every transform through impl="auto" on ``rows`` f32 rows, checked
    on the first ``oracle_rows`` against np.fft in float64."""
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.ops import fft as fft_ops

    log(f"[fft] impl='auto' resolves to {fft_ops.AUTO_IMPL!r}")
    out = []
    for n in sizes:
        kr, ki = jax.random.split(jax.random.key(n))
        xr = jax.random.normal(kr, (rows, n), jnp.float32)
        z = jax.lax.complex(xr, jax.random.normal(ki, (rows, n), jnp.float32))
        spec = jax.jit(lambda v: fft_ops.rfft(v, impl="auto"))(xr)
        runs = {
            "fft": (lambda v: fft_ops.fft(v, impl="auto"), z, np.fft.fft),
            "ifft": (lambda v: fft_ops.ifft(v, impl="auto"), z, np.fft.ifft),
            "rfft": (lambda v: fft_ops.rfft(v, impl="auto"), xr, np.fft.rfft),
            "irfft": (lambda v: fft_ops.irfft(v, n, impl="auto"), spec,
                      lambda s: np.fft.irfft(s, n)),
        }
        for kind, (fn, x, ref_fn) in runs.items():
            y = jax.block_until_ready(jax.jit(fn)(x))
            check(y.shape[0] == rows, f"{kind} n={n}: shape {y.shape}")
            xs = np.asarray(x[:oracle_rows])
            ref = ref_fn(xs.astype(np.complex128 if np.iscomplexobj(xs)
                                   else np.float64))
            snr = _snr(ref, np.asarray(y[:oracle_rows]))
            rec = dict(kind=kind, n=n, rows=rows, dtype=str(y.dtype),
                       snr_db=round(snr, 2))
            log(f"[fft] {rec}")
            check(np.isfinite(np.asarray(y[:oracle_rows])).all(),
                  f"{kind} n={n}: non-finite output")
            check(snr >= min_db, f"{kind} n={n}: {snr:.1f} dB < {min_db}")
            out.append(rec)
    return out


# -- phase 3 ---------------------------------------------------------------


def oracle_config5(x64: np.ndarray, env_hz: float = ENV_HZ) -> np.ndarray:
    """The float64 oracle of ``api.make_chain(44100, 48000,
    envelope_hz=env_hz)`` per channel (gate-length output)."""
    from audiosignalprocess_tpu.cpu_ref import oracle

    h = oracle.design_fir(64, 0.3)
    he = oracle.design_fir(129, 2.0 * env_hz / RATE_OUT)
    rows = []
    for c in range(x64.shape[0]):
        g = oracle.noise_gate(oracle.fir_direct(oracle.resample_poly(
            x64[c], 160, 147, zero_phase=False), h), noise_frames=8)
        rows.append(oracle.fir_direct(np.abs(g), he) * (np.pi / 2.0))
    return np.stack(rows)


def phase_chain(tmp: str, seed: int, channels: int = CHANNELS,
                seconds: float = SECONDS, block: int = BLOCK,
                oracle_channels: int = ORACLE_CHANNELS) -> dict:
    """Config 5 through api.chain_file, whole-file and streamed."""
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu import api
    from audiosignalprocess_tpu.io.wav import read_wav

    path = os.path.join(tmp, f"cfg5_{channels}ch_s{seed}.wav")
    common.make_test_wav(path, channels, RATE_IN, seconds, seed=seed)
    x, _ = read_wav(path, dtype=np.float32)
    chain = api.make_chain(RATE_IN, RATE_OUT, envelope_hz=ENV_HZ)
    compiled = jax.jit(chain.full_flush).lower(
        jax.ShapeDtypeStruct(x.shape, jnp.float32)).compile()
    log(f"[chain] seed={seed} whole-file step memory_analysis: "
        f"{compiled.memory_analysis()}")
    times = {}
    outs = {}
    for mode, blk in (("full", None), ("stream", block)):
        dst = os.path.join(tmp, f"cfg5_out_{mode}_s{seed}.wav")
        t0 = time.perf_counter()
        api.chain_file(path, dst, RATE_OUT, envelope_hz=ENV_HZ, block=blk,
                       float_fmt=True)
        times[mode] = time.perf_counter() - t0
        outs[mode], rate = read_wav(dst, dtype=np.float64)
        check(rate == RATE_OUT, f"output rate {rate}")
    yf, ys = outs["full"], outs["stream"]
    n_out = chain.out_len(x.shape[-1])
    check(yf.shape == ys.shape == (channels, n_out),
          f"shapes full {yf.shape} stream {ys.shape}, want {(channels, n_out)}")
    check(np.isfinite(yf).all() and np.isfinite(ys).all(), "non-finite")
    ref = oracle_config5(x[:oracle_channels].astype(np.float64))
    m = min(ref.shape[-1], n_out)
    rec = dict(
        seed=seed, channels=channels, seconds=seconds, block=block,
        wall_s_full=round(times["full"], 3),
        wall_s_stream=round(times["stream"], 3),
        snr_full_vs_oracle=round(_snr(ref[:, :m], yf[:oracle_channels, :m]), 2),
        snr_stream_vs_oracle=round(
            _snr(ref[:, :m], ys[:oracle_channels, :m]), 2),
        snr_stream_vs_full=round(_snr(yf, ys), 2),
    )
    log(f"[chain] {rec}")
    check(rec["snr_full_vs_oracle"] >= ORACLE_MIN_DB
          and rec["snr_stream_vs_oracle"] >= ORACLE_MIN_DB,
          f"seed {seed}: chain vs oracle below {ORACLE_MIN_DB} dB")
    check(rec["snr_stream_vs_full"] >= STREAM_MIN_DB,
          f"seed {seed}: stream vs full below {STREAM_MIN_DB} dB")
    return rec


def phase_config5_driver(seed: int, seconds: float = SECONDS) -> list:
    """tools/run_config_5.py stream and ring modes, their own checks."""
    from tools import run_config_5

    recs = []
    for mode in ("stream", "ring"):
        rec = run_config_5.main(["--mode", mode, "--check", "--json",
                                 "--seconds", str(seconds),
                                 "--seed", str(seed)])
        check(rec["parity"], f"config 5 {mode} seed {seed}: {rec}")
        recs.append(rec)
    return recs


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -- phase 4 ---------------------------------------------------------------


def phase_configs(seconds: dict = CONFIG_SECONDS) -> list:
    """Configs 1-4 through their drivers' --check paths."""
    import importlib

    recs = []
    for k in (1, 2, 3, 4):
        drv = importlib.import_module(f"tools.run_config_{k}")
        rec = drv.main(["--check", "--json", "--seconds", str(seconds[k])])
        check(rec.get("parity") is True, f"config {k}: {rec}")
        recs.append(rec)
    return recs


# -- phase 5 ---------------------------------------------------------------


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    check(rc == 0, f"pytest -m gpu exited {rc}")


# -- --four ------------------------------------------------------------------


def phase_four(tmp: str, seconds3: float = 30.0, seconds4: float = 10.0,
               seconds5: float = SECONDS,
               oracle_channels: int = ORACLE_CHANNELS) -> list:
    """Configs 3, 4 and 5 (sharded mode) through their drivers over every
    device, each vs the same input on one device (>= 80 dB: the sharded
    programs reassociate the same arithmetic) and vs the float64 oracle on
    a channel subset (>= 60 dB)."""
    import jax
    import jax.numpy as jnp

    from audiosignalprocess_tpu.cpu_ref import oracle
    from audiosignalprocess_tpu.io.wav import read_wav
    from audiosignalprocess_tpu.ops.fir import design_fir
    from audiosignalprocess_tpu.ops.overlap_save import overlap_save
    from audiosignalprocess_tpu.pipeline import Chain, GateStage
    from tools import run_config_3, run_config_4, run_config_5

    one = jax.devices()[0]

    def run(drv, argv, name):
        dst = os.path.join(tmp, f"four_{name}.wav")
        rec = drv.main(argv + ["--json", "--output", dst])
        y, _ = read_wav(dst, dtype=np.float64)
        return rec, y

    def single(fn, x):
        return np.asarray(jax.jit(fn)(jax.device_put(x, one)),
                          dtype=np.float64)

    out = []
    # config 3: 8 channels, 48 kHz, channel-sharded noise gate
    rec, y = run(run_config_3, ["--check", "--seconds", str(seconds3)], "c3")
    x, _ = read_wav(common.gen_wav_path(8, 48000, 0), dtype=np.float32)
    x = x[:, : y.shape[-1]]
    g = Chain([GateStage()])
    g.build()
    y1 = single(g.full, x)
    ref = np.stack([oracle.noise_gate(x[c].astype(np.float64))
                    for c in range(oracle_channels)])
    out.append(("config3", rec, y, y1, ref))

    # config 4: 64 channels, 96 kHz, 4096-tap overlap-save
    rec, y = run(run_config_4, ["--check", "--seconds", str(seconds4)], "c4")
    x, _ = read_wav(common.gen_wav_path(64, 96000, 0), dtype=np.float32)
    x = x[:, : y.shape[-1]]
    h = design_fir(4096, 0.1, window_kind="blackman")
    y1 = single(lambda v: overlap_save(v, h, 16384), x)
    ref = np.stack([oracle.fir_direct(x[c].astype(np.float64), h)
                    for c in range(oracle_channels)])
    out.append(("config4", rec, y, y1, ref))

    # config 5: 128 channels, time-sharded whole-file chain
    rec, y = run(run_config_5, ["--mode", "sharded", "--check", "--seconds",
                                str(seconds5)], "c5")
    x, _ = read_wav(common.gen_wav_path(128, RATE_IN, 0), dtype=np.float32)
    n_in = rec["in_shape"][-1]
    x = x[:, :n_in]
    chain = run_config_5.build_chain()
    chain.build()
    y1 = single(chain.full, x)
    ref = oracle_config5(x[:oracle_channels].astype(np.float64))
    out.append(("config5_sharded", rec, y, y1, ref))

    recs = []
    for name, rec, y, y1, ref in out:
        check(y.shape == y1.shape, f"{name}: {y.shape} vs one card {y1.shape}")
        m = min(ref.shape[-1], y.shape[-1])
        r = dict(config=name, devices=rec["device"]["count"],
                 shape=list(y.shape),
                 snr_vs_one_card=round(_snr(y1, y), 2),
                 snr_vs_oracle=round(_snr(ref[:, :m],
                                          y[:oracle_channels, :m]), 2))
        log(f"[four] {r}")
        check(r["snr_vs_one_card"] >= STREAM_MIN_DB,
              f"{name}: vs one card below {STREAM_MIN_DB} dB")
        check(r["snr_vs_oracle"] >= ORACLE_MIN_DB,
              f"{name}: vs oracle below {ORACLE_MIN_DB} dB")
        recs.append(r)
    return recs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the sharded configs 3/4/5 over every card")
    args = p.parse_args(argv)
    common.require_gpu()
    log(f"[device] nvidia-smi: {common.gpu_name_and_power_limit()}")
    device = phase_device()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            check(device["count"] >= 2, "--four needs several cards")
            phase_four(tmp)
        else:
            phase_fft()
            for seed in SEEDS:
                phase_chain(tmp, seed)
                for rec in phase_config5_driver(seed):
                    log(f"[chain] driver {rec}")
            log(f"[chain] peak_bytes_in_use: {peak_bytes()}")
            for rec in phase_configs():
                log(f"[configs] {rec}")
            phase_gpu_tests()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
