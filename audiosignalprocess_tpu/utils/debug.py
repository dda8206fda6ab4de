"""Debug / numerical-sanity subsystem (SURVEY.md §5 "race detection /
sanitizers" row).

The reference (single-threaded C) has none of this; the JAX
equivalents are:
- NaN/Inf trapping in jit-compiled code (``enable_nan_checks``),
- an SNR assertion helper for pinning any device path to the oracle.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np


def enable_nan_checks(enable: bool = True) -> None:
    """Trap NaN/Inf produced under jit (jax debug_nans/debug_infs)."""
    jax.config.update("jax_debug_nans", enable)
    jax.config.update("jax_debug_infs", enable)


@contextlib.contextmanager
def nan_checks():
    """Scoped NaN/Inf trapping (restores the prior global setting)."""
    prev_nans = jax.config.jax_debug_nans
    prev_infs = jax.config.jax_debug_infs
    enable_nan_checks(True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_debug_infs", prev_infs)


def assert_snr(ref, test, min_db: float = 60.0, what: str = "output") -> float:
    """Assert test matches ref to >= min_db SNR; returns the SNR."""
    from audiosignalprocess_tpu.utils.metrics import snr_db

    s = snr_db(np.asarray(ref), np.asarray(test))
    if not s >= min_db:
        raise AssertionError(f"{what}: SNR {s:.1f} dB < {min_db} dB bound")
    return s
