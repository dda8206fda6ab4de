"""FFT family: XLA's FFT, radix-2, split-radix and a four-step matmul FFT.

Capability parity with the reference's transform layer (SURVEY.md §2 rows
3-5: radix-2 FFT/IFFT with bit reversal, split-radix FFT/IFFT, real-FFT
packing).  Four implementations behind one API:

- ``impl="xla"``        — ``jnp.fft``: XLA lowers it to cuFFT on the GPU.
  The default (``"auto"`` resolves to it, see ``AUTO_IMPL``).
- ``impl="radix2"``     — iterative DIT with explicit bit-reversal, the
  classic C structure, vectorized over stages (lax-free Python stage loop,
  static shapes).  Structural-parity path.
- ``impl="splitradix"`` — recursive split-radix (L-shaped butterflies),
  trace-time recursion.  Capability-parity path.
- ``impl="matmul"``     — four-step (Bailey) factorization N = N1*N2:
  DFT_N1 matmul -> twiddle -> DFT_N2 matmul -> transpose, every matmul
  at ``Precision.HIGHEST`` (true f32; the default would be TF32 on the
  GPU, ~60 dB at best).  Kept as the measured alternative to cuFFT.

Forward is unnormalized, inverse scales 1/N (C convention, oracle-pinned).
All functions are batched over leading axes; the transform is on the last
axis, which must be a power of two for radix2/splitradix/matmul.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from audiosignalprocess_tpu.utils.validate import check

DEFAULT_IMPL = "auto"

# What ``impl="auto"`` means, for every dtype and transform: XLA's FFT
# (cuFFT on the GPU) measured 3-13x faster than the four-step matmul FFT
# at n = 1024 and 4096 on the H100 (PERF.md, FFT route table).
AUTO_IMPL = "xla"


def _resolve_impl(impl: str) -> str:
    """Resolve ``impl="auto"`` to ``AUTO_IMPL``; reject unknown names."""
    if impl == "auto":
        return AUTO_IMPL
    check(impl == "xla" or impl in _IMPLS,
          f"unknown FFT impl {impl!r}: auto, xla, {', '.join(_IMPLS)}")
    return impl

# ---------------------------------------------------------------------------
# Design-time tables (float64 numpy, embedded as constants)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    # single source of truth: the pinned oracle's bit-reversal convention
    from audiosignalprocess_tpu.cpu_ref.oracle import bit_reverse_indices

    return bit_reverse_indices(n)


@functools.lru_cache(maxsize=None)
def _twiddle(m: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """exp(sign * 2j*pi*k/(2m)) for k < m, split into (cos, sin)."""
    ang = sign * 2.0 * np.pi * np.arange(m) / (2 * m)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def _dft_mat(n: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """DFT matrix exp(sign*2j*pi*jk/n) as (real, imag) float64."""
    jk = np.outer(np.arange(n), np.arange(n))
    ang = sign * 2.0 * np.pi * jk / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def _fourstep_tw(n1: int, n2: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    cb = np.outer(np.arange(n1), np.arange(n2))
    ang = sign * 2.0 * np.pi * cb / (n1 * n2)
    return np.cos(ang), np.sin(ang)


def _split_n(n: int) -> tuple[int, int]:
    """Balanced power-of-two factorization n = n1*n2 (n1 <= n2)."""
    k = n.bit_length() - 1
    return 1 << (k // 2), 1 << (k - k // 2)


def _as_complex_dtype(dtype):
    """Complex dtype matching the precision of ``dtype`` (idempotent)."""
    if dtype in (jnp.float64, np.float64, jnp.complex128, np.complex128):
        return jnp.complex128
    return jnp.complex64


# ---------------------------------------------------------------------------
# radix-2 (iterative DIT, explicit bit reversal — C structure)
# ---------------------------------------------------------------------------


def _fft_radix2(x: jnp.ndarray, sign: float) -> jnp.ndarray:
    n = x.shape[-1]
    if n == 1:
        return x
    rdtype = jnp.float64 if x.dtype == jnp.complex128 else jnp.float32
    x = jnp.take(x, jnp.asarray(_bitrev(n)), axis=-1)
    m = 1
    while m < n:
        wc, ws = _twiddle(m, sign)
        w = jnp.asarray(wc, rdtype) + 1j * jnp.asarray(ws, rdtype)
        xv = x.reshape(x.shape[:-1] + (n // (2 * m), 2, m))
        a = xv[..., 0, :]
        b = xv[..., 1, :] * w.astype(x.dtype)
        x = jnp.concatenate([a + b, a - b], axis=-1).reshape(x.shape[:-1] + (n,))
        m *= 2
    return x


# ---------------------------------------------------------------------------
# split-radix (recursive, L-shaped butterflies)
# ---------------------------------------------------------------------------


def _fft_splitradix(x: jnp.ndarray, sign: float) -> jnp.ndarray:
    n = x.shape[-1]
    if n == 1:
        return x
    if n == 2:
        return jnp.stack([x[..., 0] + x[..., 1], x[..., 0] - x[..., 1]], axis=-1)
    u = _fft_splitradix(x[..., 0::2], sign)
    z = _fft_splitradix(x[..., 1::4], sign)
    zp = _fft_splitradix(x[..., 3::4], sign)
    k = np.arange(n // 4)
    w1 = np.exp(sign * 2j * np.pi * k / n)
    w3 = np.exp(sign * 2j * np.pi * 3 * k / n)
    cdt = x.dtype
    zw = z * jnp.asarray(w1, cdt)
    zpw = zp * jnp.asarray(w3, cdt)
    s = zw + zpw
    d = (1j if sign > 0 else -1j) * (zw - zpw)
    uk = u[..., : n // 4]
    ukq = u[..., n // 4 : n // 2]
    return jnp.concatenate([uk + s, ukq + d, uk - s, ukq - d], axis=-1)


# ---------------------------------------------------------------------------
# four-step matmul FFT
# ---------------------------------------------------------------------------


def _fft_matmul_planar(
    xr: jnp.ndarray, xi: jnp.ndarray, sign: float
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Four-step FFT on (real, imag) planes; last axis length n = n1*n2.

    With n = n2*a + b and k = n1*d + c:
      step 1: Y[c,b] = sum_a F_{n1}[c,a] X[a,b]        (matmul)
      step 2: Z[c,b] = Y[c,b] * W_n^{cb}               (twiddle)
      step 3: out[c,d] = sum_b Z[c,b] F_{n2}[b,d]      (matmul)
      natural order: transpose (d,c) and flatten.
    """
    n = xr.shape[-1]
    if n == 1:
        return xr, xi
    rdtype = xr.dtype
    n1, n2 = _split_n(n)
    f1r_, f1i_ = _dft_mat(n1, sign)
    f2r_, f2i_ = _dft_mat(n2, sign)
    twr_, twi_ = _fourstep_tw(n1, n2, sign)
    f1r, f1i = jnp.asarray(f1r_, rdtype), jnp.asarray(f1i_, rdtype)
    f2r, f2i = jnp.asarray(f2r_, rdtype), jnp.asarray(f2i_, rdtype)
    twr, twi = jnp.asarray(twr_, rdtype), jnp.asarray(twi_, rdtype)

    batch = xr.shape[:-1]
    xr = xr.reshape(batch + (n1, n2))
    xi = xi.reshape(batch + (n1, n2))

    def cm_left(mr, mi, ar, ai):  # (mr+i mi) @ (ar+i ai), contract a-axis
        rr = jnp.einsum("ca,...ab->...cb", mr, ar, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ri = jnp.einsum("ca,...ab->...cb", mr, ai, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ir = jnp.einsum("ca,...ab->...cb", mi, ar, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ii = jnp.einsum("ca,...ab->...cb", mi, ai, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        return rr - ii, ri + ir

    def cm_right(ar, ai, mr, mi):  # (ar+i ai) @ (mr+i mi), contract b-axis
        rr = jnp.einsum("...cb,bd->...cd", ar, mr, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ri = jnp.einsum("...cb,bd->...cd", ar, mi, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ir = jnp.einsum("...cb,bd->...cd", ai, mr, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        ii = jnp.einsum("...cb,bd->...cd", ai, mi, preferred_element_type=rdtype,
                         precision=jax.lax.Precision.HIGHEST)
        return rr - ii, ri + ir

    yr, yi = cm_left(f1r, f1i, xr, xi)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    or_, oi_ = cm_right(zr, zi, f2r, f2i)
    or_ = jnp.swapaxes(or_, -1, -2).reshape(batch + (n,))
    oi_ = jnp.swapaxes(oi_, -1, -2).reshape(batch + (n,))
    return or_, oi_


def _fft_matmul(x: jnp.ndarray, sign: float) -> jnp.ndarray:
    yr, yi = _fft_matmul_planar(jnp.real(x), jnp.imag(x), sign)
    return (yr + 1j * yi).astype(x.dtype)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_IMPLS = {
    "radix2": _fft_radix2,
    "splitradix": _fft_splitradix,
    "matmul": _fft_matmul,
}


def fft(x: jnp.ndarray, impl: str = DEFAULT_IMPL) -> jnp.ndarray:
    """Forward FFT on the last axis (unnormalized)."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(_as_complex_dtype(x.dtype))
    impl = _resolve_impl(impl)
    if impl == "xla":
        return jnp.fft.fft(x)
    n = x.shape[-1]
    check(n & (n - 1) == 0, "power-of-two length required")
    return _IMPLS[impl](x, -1.0)


def ifft(x: jnp.ndarray, impl: str = DEFAULT_IMPL) -> jnp.ndarray:
    """Inverse FFT on the last axis, scaled 1/N."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(_as_complex_dtype(x.dtype))
    impl = _resolve_impl(impl)
    if impl == "xla":
        return jnp.fft.ifft(x)
    n = x.shape[-1]
    check(n & (n - 1) == 0, "power-of-two length required")
    return _IMPLS[impl](x, 1.0) / n


def rfft(x: jnp.ndarray, impl: str = DEFAULT_IMPL) -> jnp.ndarray:
    """Real FFT via N/2-point complex FFT + untangle (N/2+1 bins).

    Structural match of the classic C real-packing (SURVEY.md §2 row 5).
    """
    x = jnp.asarray(x)
    # the even/odd packing below assumes a REAL signal; complex input
    # would silently compute garbage on every non-xla impl
    check(not jnp.issubdtype(x.dtype, jnp.complexfloating),
          "rfft requires a real-valued input (use fft for complex signals)")
    impl = _resolve_impl(impl)
    if impl == "xla":
        return jnp.fft.rfft(x)
    n = x.shape[-1]
    check(n & (n - 1) == 0 and n >= 2, "power-of-two length >= 2 required")
    half = n // 2
    cdt = _as_complex_dtype(x.dtype)
    if half == 1:
        a, b = x[..., 0], x[..., 1]
        return jnp.stack([a + b, a - b], axis=-1).astype(cdt)
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(cdt)
    zf = _IMPLS[impl](z, -1.0)
    zk = jnp.concatenate([zf, zf[..., :1]], axis=-1)
    zkc = jnp.conj(zk[..., ::-1])
    xe = 0.5 * (zk + zkc)
    xo = -0.5j * (zk - zkc)
    w = np.exp(-2j * np.pi * np.arange(half + 1) / n)
    return xe + jnp.asarray(w, cdt) * xo


def irfft(spec: jnp.ndarray, n: int, impl: str = DEFAULT_IMPL) -> jnp.ndarray:
    """Inverse real FFT: n real samples from n/2+1 bins (1/N scaling)."""
    spec = jnp.asarray(spec)
    impl = _resolve_impl(impl)
    if impl == "xla":
        return jnp.fft.irfft(spec, n)
    half = n // 2
    # real output precision matches the spectrum's (spec may arrive REAL,
    # e.g. a magnitude spectrum, so match f64 for both c128 and f64)
    rdtype = (jnp.float64 if spec.dtype in (jnp.complex128, jnp.float64)
              else jnp.float32)
    if half == 1:
        a, b = jnp.real(spec[..., 0]), jnp.real(spec[..., 1])
        return (jnp.stack([a + b, a - b], axis=-1) * 0.5).astype(rdtype)
    zk = spec[..., : half + 1].astype(_as_complex_dtype(spec.dtype))
    zkc = jnp.conj(zk[..., ::-1])
    xe = 0.5 * (zk + zkc)
    # cast the twiddles to the COMPLEX dtype: spec may arrive real (a
    # magnitude spectrum), and a real-dtype cast would silently discard
    # the twiddles' imaginary part
    wback = np.exp(2j * np.pi * np.arange(half + 1) / n)
    xo = 0.5 * (zk - zkc) * jnp.asarray(wback, zk.dtype)
    z = (xe + 1j * xo)[..., :half]
    zt = _IMPLS[impl](z, 1.0) / half
    out = jnp.stack([jnp.real(zt), jnp.imag(zt)], axis=-1)
    return out.reshape(spec.shape[:-1] + (n,)).astype(rdtype)


def fft_flops(n: int) -> float:
    """Nominal real-FLOP count of a radix-2 complex FFT (5 N log2 N)."""
    return 5.0 * n * math.log2(n)
