"""Overlap-save fast block convolution (SURVEY.md §2 row 8).

Identical output to ``fir_direct`` (causal, length == len(x)), pinned by
cpu_ref/oracle.overlap_save: block size B = nfft - (T-1); each block's
input is the previous T-1 samples + B new ones; the first T-1 outputs per
block are discarded.

All blocks go through one batched rfft/irfft — the block axis is a pure
batch axis, so the whole operation is two batched FFTs and an elementwise
spectrum multiply.  The time-sharded variant exchanges the T-1-sample halo via ppermute
(parallel/sharded.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.utils.validate import check


def spectrum_taps(h, nfft: int, dtype=np.complex64) -> np.ndarray:
    """rfft of zero-padded taps (design-time, float64 then cast)."""
    h = np.asarray(h, dtype=np.float64)
    hf = np.fft.rfft(np.concatenate([h, np.zeros(nfft - len(h))]))
    return hf.astype(dtype)


def overlap_save(
    x: jnp.ndarray,
    h,
    nfft: int,
    history: jnp.ndarray | None = None,
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """Causal FIR via overlap-save on the last axis; output length == input.

    ``history``: optional (..., T-1) previous inputs (streaming); zeros
    when absent (cold start).
    """
    x = jnp.asarray(x)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    check(nfft > t - 1, "nfft must exceed numtaps-1")
    b = nfft - (t - 1)
    n = x.shape[-1]
    nblocks = -(-n // b)
    batch = x.shape[:-1]
    if history is None:
        head = jnp.zeros(batch + (t - 1,), x.dtype)
    else:
        head = jnp.asarray(history).astype(x.dtype)
        check(head.shape[-1] == t - 1, 'guard failed: head.shape[-1] == t - 1')
    xp = jnp.concatenate(
        [head, x, jnp.zeros(batch + (nblocks * b - n,), x.dtype)], axis=-1
    )
    # overlapping blocks: block k = xp[k*b : k*b + nfft]
    idx = np.arange(nfft)[None, :] + b * np.arange(nblocks)[:, None]
    blocks = jnp.take(xp, jnp.asarray(idx.reshape(-1)), axis=-1).reshape(
        batch + (nblocks, nfft)
    )
    cdt = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    hf = jnp.asarray(spectrum_taps(h, nfft, dtype=np.complex128), cdt)
    y = fft_ops.irfft(fft_ops.rfft(blocks, impl=impl) * hf, nfft, impl=impl)
    y = y[..., t - 1 :].reshape(batch + (nblocks * b,))
    return y[..., :n]
