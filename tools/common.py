"""Shared helpers for the config drivers (SURVEY.md §2 row 15: the
reference's per-effect demo mains, rebuilt as per-config runners for the
five driver configs of BASELINE.json:7-11)."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.utils.compile_cache import setup_compile_cache
from audiosignalprocess_tpu.utils.validate import check
from audiosignalprocess_tpu.io.wav import read_wav, write_wav

# every driver imports this module before its first compile
setup_compile_cache()


def make_test_wav(path: str, channels: int, rate: int, seconds: float,
                  kind: str = "tone+noise", seed: int = 0) -> None:
    """Generate a deterministic multichannel test WAV."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = np.zeros((channels, n))
    for c in range(channels):
        f = 220.0 * (2.0 ** (c % 12 / 12.0))
        if kind == "tone+noise":
            x[c] = 0.01 * rng.standard_normal(n)
            gate = (t > 0.25 * seconds / 1.0) & (t < 0.7 * seconds)
            x[c] += np.where(gate, 0.5 * np.sin(2 * np.pi * f * t), 0.0)
        elif kind == "am":
            x[c] = (1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) * np.sin(2 * np.pi * f * t) * 0.4
        else:
            x[c] = 0.5 * np.sin(2 * np.pi * f * t)
    write_wav(path, x, rate, float_fmt=True)


def std_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--input", default=None, help="input WAV (generated if omitted)")
    p.add_argument("--output", default=None, help="output WAV path")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--check", action="store_true", help="verify vs CPU oracle")
    p.add_argument("--bench", action="store_true", help="timed re-runs")
    p.add_argument("--json", action="store_true", help="print metrics as JSON")
    # second data regime for the per-round records (VERDICT r4 item 6:
    # gate-decision SNR is input-dependent; one seed can hide 26 dB)
    p.add_argument("--seed", type=int, default=0,
                   help="generated-input RNG seed (ignored with --input)")
    return p


def gen_wav_path(channels: int, rate: int, seed: int) -> str:
    """Where ``load_or_make`` writes its generated input WAV."""
    return os.path.join(tempfile.gettempdir(),
                        f"asp_gen_{channels}ch_{rate}_s{seed}.wav")


def load_or_make(args, channels: int, rate: int, kind: str = "tone+noise"):
    if args.input:
        x, r = read_wav(args.input, dtype=np.float32)
        check(r == rate, f"expected {rate} Hz input, got {r}")
        return x
    seed = getattr(args, "seed", 0)
    path = gen_wav_path(channels, rate, seed)
    make_test_wav(path, channels, rate, args.seconds, kind, seed=seed)
    x, _ = read_wav(path, dtype=np.float32)
    return x


def require_gpu() -> None:
    """Exit non-zero unless JAX's first device is a GPU: a measurement or
    smoke run never falls back to another platform."""
    import sys

    import jax

    plat = jax.devices()[0].platform
    if plat != "gpu":
        sys.exit(f"no GPU: JAX's first device is on platform {plat!r}")


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them
    (a subprocess: it does not touch JAX)."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def device_record() -> dict:
    """The device a run used, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def report(name: str, x, out, dt: float | None, snr: float | None,
           args) -> dict:
    """Print (and return) one run's record, naming the device."""
    rec = {
        "config": name,
        "device": device_record(),
        "in_shape": list(np.shape(x)),
        "out_shape": list(np.shape(out)),
    }
    if dt is not None:
        rec["seconds_per_run"] = round(dt, 6)
        rec["samples_per_s"] = round(float(np.prod(np.shape(x))) / dt, 1)
    if snr is not None:
        rec["snr_db_vs_oracle"] = round(snr, 2)
        rec["parity"] = bool(snr >= 60.0)
    if args.json:
        print(json.dumps(rec))
    else:
        for k, v in rec.items():
            print(f"  {k}: {v}")
    return rec


def timed(fn, x, iters: int = 5):
    """Mean wall time of ``fn(x)`` over ``iters`` calls after one warm-up
    (compile) call; each call ends in ``block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(x))
    dt = (time.perf_counter() - t0) / iters
    return out, dt


def to_host(out) -> np.ndarray:
    """Fetch a (possibly globally-sharded) array to the host: multi-process
    arrays span non-addressable devices, so allgather across processes."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(out, tiled=True))
    return np.asarray(out)


def maybe_write(args, out, rate: int) -> None:
    if args.output:
        write_wav(args.output, np.asarray(out), rate, float_fmt=True)


snr_db = oracle.snr_db
