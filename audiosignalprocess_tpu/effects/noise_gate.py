"""Spectral noise gate (SURVEY.md §2 row 13), oracle-pinned.

Per-bin noise floor = mean |STFT| over the first ``noise_frames`` frames;
hard mask (attenuation ``10**(-reduction_db/20)`` below
floor*10**(threshold_db/20)); optional one-pole release smoothing of the
mask along frames (associative-scan-friendly); WOLA resynthesis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.stft import istft, num_frames, stft
from audiosignalprocess_tpu.utils.validate import check


def gate_mask(
    mag: jnp.ndarray,
    floor: jnp.ndarray,
    threshold_db: float,
    reduction_db: float,
    release: float = 0.0,
) -> jnp.ndarray:
    """Mask from magnitudes and a per-bin noise floor (frames axis = -2)."""
    thresh = floor * (10.0 ** (threshold_db / 20.0))
    att = 10.0 ** (-reduction_db / 20.0)
    mask = jnp.where(mag > thresh, 1.0, att).astype(mag.dtype)
    if release > 0.0:
        # release smoothing s_k = max(mask_k, r * s_{k-1}): max-with-decay,
        # associative -> log-depth scan over frames on device.
        def combine(a, b):
            da, va = a
            db, vb = b
            return da * db, jnp.maximum(va * db, vb)

        decays = jnp.full_like(mask, release)
        _, mask = jax.lax.associative_scan(combine, (decays, mask), axis=-2)
    return mask


def noise_gate(
    x: jnp.ndarray,
    nfft: int = 1024,
    hop: int = 256,
    threshold_db: float = 6.0,
    reduction_db: float = 60.0,
    noise_frames: int = 8,
    release: float = 0.0,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """Gate on the last axis.  Output length = istft length of the frames."""
    nframes = num_frames(jnp.shape(x)[-1], nfft, hop)
    check(nframes >= noise_frames, f"signal has {nframes} frames < noise_frames={noise_frames}")
    spec = stft(x, nfft, hop, window_kind, impl=impl)
    mag = jnp.abs(spec)
    floor = jnp.mean(mag[..., :noise_frames, :], axis=-2, keepdims=True)
    mask = gate_mask(mag, floor, threshold_db, reduction_db, release)
    return istft(spec * mask, nfft, hop, window_kind, impl=impl)
