"""STFT analysis / ISTFT synthesis (WOLA), oracle-pinned conventions.

Framing (SURVEY.md §2 rows 10-11): frame k = x[k*hop : k*hop+nfft], no
center padding, no partial frames; ISTFT overlap-adds w*irfft(S) and
normalizes by the summed squared window (clamped).  Output length
= nfft + (frames-1)*hop.

Framing is a gather with a contiguous inner window (XLA lowers it to
dynamic slices); the overlap-add uses the reshape-diagonal trick when hop
divides nfft (R = nfft//hop static adds instead of a scatter), so the
whole transform stays dense elementwise and FFT work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.windows import window
from audiosignalprocess_tpu.utils.validate import check


def num_frames(n: int, nfft: int, hop: int) -> int:
    check(n >= nfft, "signal shorter than one frame")
    return 1 + (n - nfft) // hop


def frame(x: jnp.ndarray, nfft: int, hop: int) -> jnp.ndarray:
    """(..., n) -> (..., frames, nfft) strided framing."""
    n = x.shape[-1]
    nf = num_frames(n, nfft, hop)
    idx = np.arange(nfft)[None, :] + hop * np.arange(nf)[:, None]
    return jnp.take(x, jnp.asarray(idx.reshape(-1)), axis=-1).reshape(
        x.shape[:-1] + (nf, nfft)
    )


def stft(
    x: jnp.ndarray,
    nfft: int,
    hop: int,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """STFT -> (..., frames, nfft//2+1) complex."""
    x = jnp.asarray(x)
    w = window(window_kind, nfft, periodic=True, dtype=x.dtype)
    return fft_ops.rfft(frame(x, nfft, hop) * w, impl=impl)


def overlap_add(frames: jnp.ndarray, hop: int) -> jnp.ndarray:
    """(..., F, nfft) -> (..., nfft + (F-1)*hop) overlap-add.

    When hop | nfft uses the reshape-diagonal formulation (R static adds);
    otherwise falls back to scatter-add.
    """
    nf, nfft = frames.shape[-2], frames.shape[-1]
    nout = nfft + (nf - 1) * hop
    if nfft % hop == 0:
        r = nfft // hop
        fr = frames.reshape(frames.shape[:-1] + (r, hop))
        rows = nf + r - 1  # output viewed as (rows, hop)
        acc = jnp.zeros(frames.shape[:-2] + (rows, hop), frames.dtype)
        for j in range(r):
            acc = acc.at[..., j : j + nf, :].add(fr[..., :, j, :])
        return acc.reshape(frames.shape[:-2] + (rows * hop,))[..., :nout]
    out = jnp.zeros(frames.shape[:-2] + (nout,), frames.dtype)
    for k in range(nf):
        out = out.at[..., k * hop : k * hop + nfft].add(frames[..., k, :])
    return out


def _wola_norm(nf: int, nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample sum of squared windows (float64, design time)."""
    w2 = oracle.window(window_kind, nfft, periodic=True) ** 2
    nout = nfft + (nf - 1) * hop
    norm = np.zeros(nout)
    for k in range(nf):
        norm[k * hop : k * hop + nfft] += w2
    return oracle.wola_clamp(norm)


def istft(
    spec: jnp.ndarray,
    nfft: int,
    hop: int,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """WOLA inverse STFT.  Output length = nfft + (frames-1)*hop."""
    nf = spec.shape[-2]
    t = fft_ops.irfft(spec, nfft, impl=impl)
    w = window(window_kind, nfft, periodic=True, dtype=t.dtype)
    y = overlap_add(t * w, hop)
    inv = jnp.asarray(1.0 / _wola_norm(nf, nfft, hop, window_kind), t.dtype)
    return y * inv
