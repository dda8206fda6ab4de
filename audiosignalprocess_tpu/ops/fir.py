"""FIR design + direct-form filtering (SURVEY.md §2 rows 6-7).

Design is host-side float64 (delegates to the oracle so taps are shared
bit-for-bit with the CPU reference).  ``fir_direct`` is the causal
direct-form filter: y[n] = sum_t h[t] x[n-t], output length == len(x).
It lowers to one XLA convolution at ``Precision.HIGHEST`` (true f32: the
default precision would run TF32 on the GPU, ~60 dB at best).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from audiosignalprocess_tpu.cpu_ref import oracle


def design_fir(
    numtaps: int, cutoff, window_kind: str = "hann", pass_zero: bool = True
) -> np.ndarray:
    """Windowed-sinc linear-phase FIR taps (float64 numpy, firwin-compatible)."""
    return oracle.design_fir(numtaps, cutoff, window_kind, pass_zero=pass_zero)


def fir_direct(x: jnp.ndarray, h,
               history: jnp.ndarray | None = None) -> jnp.ndarray:
    """Causal direct-form FIR on the last axis, output length == len(x).

    ``history``: optional (..., T-1) previous input samples for streaming
    continuity (defaults to zeros — cold start, matching the oracle).
    """
    x = jnp.asarray(x)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    batch = x.shape[:-1]
    n = x.shape[-1]
    xf = x.reshape((-1, 1, n))  # (batch, feature=1, length)
    if history is not None and t > 1:  # t==1: stateless, no history needed
        hist = jnp.asarray(history).reshape((-1, 1, t - 1)).astype(x.dtype)
        xf = jnp.concatenate([hist, xf], axis=-1)
        pad = (0, 0)
    else:
        pad = (t - 1, 0)
    # correlation with reversed taps == causal convolution
    rhs = jnp.asarray(h[::-1].copy(), x.dtype).reshape((1, 1, t))
    y = lax.conv_general_dilated(
        xf, rhs, window_strides=(1,), padding=[pad],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(batch + (n,))
