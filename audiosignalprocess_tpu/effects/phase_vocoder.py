"""Phase-vocoder pitch/time processing (SURVEY.md §2 row 14), oracle-pinned.

Time stretch: output frame i samples analysis position t_i = i*rate
(frames), linearly interpolating magnitude and accumulating the
deviation-corrected instantaneous frequency.  The phase accumulation is a
prefix sum — implemented as a ``jnp.cumsum`` over frames (no sequential
scan), so the whole vocoder is dense batched tensor work.

Pitch shift = time stretch by 1/factor + polyphase resample by the
rational approximation of the factor.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.resample import resample_poly
from audiosignalprocess_tpu.ops.stft import istft, num_frames, stft


def _wrap(p: jnp.ndarray) -> jnp.ndarray:
    return p - 2.0 * jnp.pi * jnp.round(p / (2.0 * jnp.pi))


# -- rotor phase accumulation -------------------------------------------------
#
# The accumulated synthesis phase is used only mod 2*pi, and the per-frame
# advance rotor collapses exactly: e^{i*dphi} = e^{i*(wrap(angle(s1)
# -angle(s0)-w)+w)} = unit(s1*conj(s0)).  Accumulating UNIT ROTORS by
# complex multiplication (planar re/im) instead of summing angles removes
# every angle extraction, trig call, and large-magnitude f32 sum from the
# hot path: each step costs ~1 ulp, so a 10^4-frame stream drifts ~1e-5
# rad.  The angle-sum form (oracle.time_stretch pins it in f64) reaches
# only ~52 dB in f32 — the sum grows like pi*frames and the angles of
# near-zero bins are ill-conditioned.  Rotor and angle forms are equal mod
# 2*pi exactly.


def unit_rotor(zr, zi, eps: float = 1e-36):
    """(zr, zi)/|z|, mapping |z| <= eps to the neutral rotor 1+0j (a zero
    product must not annihilate the running phase product)."""
    m2 = zr * zr + zi * zi
    ok = m2 > eps
    inv = jnp.where(ok, jax.lax.rsqrt(jnp.where(ok, m2, 1.0)), 0.0)
    return jnp.where(ok, zr * inv, 1.0), jnp.where(ok, zi * inv, 0.0)


def cumrotor(ur, ui, axis: int = -2):
    """Inclusive cumulative product of planar rotors along ``axis``
    (log-depth associative scan — the parallel prefix 'sum')."""

    def comb(a, b):
        ar, ai = a
        br, bi = b
        return ar * br - ai * bi, ar * bi + ai * br

    return jax.lax.associative_scan(comb, (ur, ui), axis=axis)


def _rotor_phase(spec, s0, s1):
    """Exclusive prefix rotors P_i = unit(spec[0]) * prod_{j<i}
    unit(s1_j conj(s0_j)) as planar (Pr, Pi), frames on axis -2."""
    s0r, s0i = jnp.real(s0), jnp.imag(s0)
    s1r, s1i = jnp.real(s1), jnp.imag(s1)
    ur, ui = unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
    cr, ci = cumrotor(ur, ui)
    one = jnp.ones_like(cr[..., :1, :])
    zero = jnp.zeros_like(one)
    er = jnp.concatenate([one, cr[..., :-1, :]], axis=-2)
    ei = jnp.concatenate([zero, ci[..., :-1, :]], axis=-2)
    z0r, z0i = unit_rotor(jnp.real(spec[..., 0:1, :]),
                          jnp.imag(spec[..., 0:1, :]))
    return z0r * er - z0i * ei, z0r * ei + z0i * er


def _stretch_at(spec: jnp.ndarray, k: np.ndarray, frac: jnp.ndarray) -> jnp.ndarray:
    """Shared stretch body: interpolate magnitudes at analysis positions
    k + frac and rebuild phase with the exclusive prefix rotors.  The
    textbook expected-advance term (omega = 2*pi*bin*hop/nfft) cancels
    exactly in the rotor form — unit(s1 conj(s0)) already carries the
    full inter-frame phase increment — so no omega array appears here."""
    s0 = jnp.take(spec, jnp.asarray(k), axis=-2)
    s1 = jnp.take(spec, jnp.asarray(k + 1), axis=-2)
    mag = (1.0 - frac) * jnp.abs(s0) + frac * jnp.abs(s1)
    pr, pi = _rotor_phase(spec, s0, s1)
    return (mag * (pr + 1j * pi)).astype(spec.dtype)


def stretch_spec(spec: jnp.ndarray, rate: float, nfft: int, hop: int) -> jnp.ndarray:
    """Resample an STFT along frames with phase accumulation (vectorized)."""
    nf = spec.shape[-2]
    steps = np.arange(0, nf - 1, rate)  # static
    k = np.floor(steps).astype(np.int64)
    frac = jnp.asarray(steps - k, jnp.real(spec).dtype)[..., :, None]
    return _stretch_at(spec, k, frac)


def stretch_steps_rational(nf: int, p: int, q: int):
    """Exact integer analysis positions for rate p/q: output frame i maps
    to t_i = i*p/q, emitted while t_i < nf-1.  Returns (k, frac_num) with
    k_i = (i*p)//q and frac_i = (i*p % q)/q — the integer-exact version of
    ``np.arange(0, nf-1, rate)`` (float steps can land one ulp below an
    integer and pick the wrong frame; streaming/sharded parity needs the
    exact grid)."""
    nof = 0 if nf < 2 else (((nf - 1) * q - 1) // p) + 1
    i = np.arange(nof)
    return (i * p) // q, (i * p) % q


def stretch_spec_rational(spec: jnp.ndarray, p: int, q: int, nfft: int,
                          hop: int) -> jnp.ndarray:
    """stretch_spec with an exact rational rate p/q (see
    stretch_steps_rational).  Used by the streaming StretchStage and the
    sharded vocoder so all three paths share one frame grid."""
    nf = spec.shape[-2]
    k, fnum = stretch_steps_rational(nf, p, q)
    frac = jnp.asarray(fnum / q, jnp.real(spec).dtype)[..., :, None]
    return _stretch_at(spec, k, frac)


def time_stretch(
    x: jnp.ndarray,
    rate: float,
    nfft: int = 1024,
    hop: int = 256,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """Phase-vocoder time stretch (rate > 1 speeds up)."""
    spec = stft(x, nfft, hop, window_kind, impl=impl)
    out = stretch_spec(spec, rate, nfft, hop)
    return istft(out, nfft, hop, window_kind, impl=impl)


def pitch_shift(
    x: jnp.ndarray,
    semitones: float,
    nfft: int = 1024,
    hop: int = 256,
    window_kind: str = "hann",
    resample_quant: int = 128,
    impl: str = fft_ops.DEFAULT_IMPL,
) -> jnp.ndarray:
    """Pitch shift by semitones; output has ~the input duration."""
    factor = 2.0 ** (semitones / 12.0)
    fr = Fraction(factor).limit_denominator(resample_quant)
    up, down = fr.denominator, fr.numerator
    y = time_stretch(x, 1.0 / factor, nfft, hop, window_kind, impl=impl)
    return resample_poly(y, up, down)


def output_frames(n: int, rate: float, nfft: int, hop: int) -> int:
    """Static output frame count of stretch_spec for input length n."""
    nf = num_frames(n, nfft, hop)
    return len(np.arange(0, nf - 1, rate))
