"""Polyphase rational resampler (SURVEY.md §2 row 9), e.g. 44.1->48 kHz = 160/147.

Convention pinned by cpu_ref/oracle.resample_poly: causal polyphase
y[j] = sum_k h[p_j + up*k] * x[m_j - k] with j*down = m_j*up + p_j;
``zero_phase=True`` advances by the filter group delay.  Output length
= ceil(len(x)*up/down).

Polyphase form: output j = c*up + r (cycle c, phase slot r) reads the
input window x[c*down - (nk-1) : c*down - (nk-1) + W] through row r of a
static (up, W) phase matrix (``phase_matrix``).  That is ONE strided
``lax.conv_general_dilated`` (stride ``down``, ``up`` output features)
at ``Precision.HIGHEST`` (true f32 on the GPU, not TF32).  Nothing is
zero-stuffed: an upsample-then-filter convolution (``lhs_dilation=up``)
would materialize ``up`` times the input — 100 GiB for config 5 on a
GPU.
"""

from __future__ import annotations

from math import gcd

import jax.numpy as jnp
import numpy as np
from jax import lax

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.utils.validate import check

resample_filter = oracle.resample_filter


def taps_per_phase(h_len: int, up: int) -> int:
    """nk = ceil(len(h)/up): polyphase taps per phase."""
    return -(-h_len // up)


def history_len(h_len: int, up: int, down: int) -> int:
    """Streaming history: >= nk-1 input samples, rounded up to a multiple
    of ``down`` so the block output count stays integral."""
    nk = taps_per_phase(h_len, up)
    return -(-(nk - 1) // down) * down


def phase_matrix(h, up: int, down: int, delay: int = 0) -> np.ndarray:
    """(up, W) float64 matrix A of the polyphase form: output c*up + r is
    sum_w A[r, w] * x[c*down - (nk-1) + w], with nk = taps_per_phase and
    ``delay`` the advance in upsampled samples (0: causal)."""
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    nk = taps_per_phase(t, up)
    r = np.arange(up)
    pos = r * down + delay
    m = pos // up  # newest input sample of slot r, relative to c*down
    p = pos - m * up  # its polyphase phase
    a = np.zeros((up, int(m.max()) + nk))
    for k in range(nk):
        tap = p + up * k
        ok = tap < t
        a[r[ok], m[ok] - k + nk - 1] = h[tap[ok]]
    return a


def resample_poly(
    x: jnp.ndarray,
    up: int,
    down: int,
    h=None,
    zero_phase: bool = True,
    history: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rational resample on the last axis.  Output ceil(n*up/down) samples.

    ``history``: optional (..., H) previous input samples for streaming
    (requires zero_phase=False, H a multiple of ``down``, and
    len(x) a multiple of ``down``); returns the len(x)*up/down outputs of
    the new block, continuing the global causal stream exactly.
    """
    g = gcd(up, down)
    up, down = up // g, down // g
    x = jnp.asarray(x)
    if up == 1 and down == 1:
        return x
    if h is None:
        h = resample_filter(up, down)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    batch = x.shape[:-1]

    if history is not None:
        check(not zero_phase, "streaming resample must be causal")
        hist = jnp.asarray(history).astype(x.dtype)
        hn = hist.shape[-1]
        check(hn % down == 0 and x.shape[-1] % down == 0, 'guard failed: hn % down == 0 and x.shape[-1] % down == 0')
        check(hn >= taps_per_phase(t, up) - 1, f"history {hn} shorter than the filter needs "
            f"({taps_per_phase(t, up) - 1}); use history_len()")
        skip = hn * up // down
        nout = x.shape[-1] * up // down
        x = jnp.concatenate([hist, x], axis=-1)
    else:
        skip = 0
        nout = -(-x.shape[-1] * up // down)

    n = x.shape[-1]
    delay = (t - 1) // 2 if zero_phase else 0
    a = phase_matrix(h, up, down, delay)
    nk = taps_per_phase(t, up)
    w = a.shape[1]
    cycles = -(-(skip + nout) // up)
    # x[i] sits at xp[i + nk - 1]; cycle c reads xp[c*down : c*down + w]
    xp = jnp.pad(x, [(0, 0)] * len(batch) + [(
        nk - 1, max(0, (cycles - 1) * down + w - (nk - 1) - n))])
    # one strided convolution with ``up`` output features: feature r of
    # cycle c is sum_w a[r, w] * xp[c*down + w] (correlation, no flip)
    y = lax.conv_general_dilated(
        xp.reshape((-1, 1, xp.shape[-1])),
        jnp.asarray(a, x.dtype).reshape((up, 1, w)),
        window_strides=(down,), padding=[(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
    )[..., :cycles]
    y = jnp.swapaxes(y, -1, -2).reshape(batch + (cycles * up,))
    return y[..., skip : skip + nout]
