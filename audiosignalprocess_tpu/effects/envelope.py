"""Envelope follower / AM demodulation (SURVEY.md §2 row 12).

Convention (oracle-pinned): full-wave rectify -> causal FIR lowpass,
scaled by pi/2 (sine-carrier calibration).  ``hilbert_envelope`` is the
analytic-signal variant via rfft spectrum doubling.
Pure elementwise work + the FIR path (one XLA convolution).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.fir import design_fir, fir_direct


def envelope(x: jnp.ndarray, h, history: jnp.ndarray | None = None) -> jnp.ndarray:
    """Rectify-and-smooth envelope; ``h`` = lowpass FIR taps."""
    return fir_direct(jnp.abs(jnp.asarray(x)), h, history=history) * (math.pi / 2.0)


def am_demod(x: jnp.ndarray, h) -> jnp.ndarray:
    """AM demodulation: envelope with the DC carrier removed (per channel)."""
    e = envelope(x, h)
    return e - jnp.mean(e, axis=-1, keepdims=True)


def default_envelope_fir(fs: float, fc: float = 50.0, numtaps: int = 129) -> np.ndarray:
    """Convenience lowpass design for envelope smoothing."""
    return design_fir(numtaps, 2.0 * fc / fs)


def hilbert_envelope(x: jnp.ndarray, impl: str = fft_ops.DEFAULT_IMPL) -> jnp.ndarray:
    """|analytic signal| via spectrum doubling (power-of-two length)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    spec = fft_ops.rfft(x, impl=impl)  # n//2+1 bins
    gain = np.full(n // 2 + 1, 2.0)
    gain[0] = 1.0
    gain[n // 2] = 1.0
    half = spec * jnp.asarray(gain, spec.dtype)
    full = jnp.concatenate(
        [half, jnp.zeros(x.shape[:-1] + (n - n // 2 - 1,), spec.dtype)], axis=-1
    )
    analytic = fft_ops.ifft(full, impl=impl)
    return jnp.abs(analytic)
