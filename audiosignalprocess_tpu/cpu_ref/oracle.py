"""Float64 numpy golden reference ("the C implementation, pinned").

The reference repo (templeblock/audioSignalProcess) is a single-threaded C
DSP codebase (BASELINE.json:5); its mount was empty at survey time
(SURVEY.md §0), so this module pins the exact structural conventions that
a straightforward C implementation of each algorithm uses, and every
JAX path in the framework is required to match it bit-for-bit in
structure (lengths, framing, ordering, scaling) and >= 60 dB SNR
numerically.  A literal C oracle with the same conventions lives in
``audiosignalprocess_tpu/native/asp_ref.c`` and is cross-checked against
this module.

Pinned conventions
------------------
- ``fft``:  X[k] = sum_n x[n] * exp(-2j*pi*n*k/N), unnormalized forward;
  ``ifft`` scales by 1/N.  Power-of-two N.
- ``rfft``: returns bins 0..N/2 inclusive (N/2+1 complex bins).
- windows: ``periodic=True`` (DFT-even) for STFT, ``periodic=False``
  (symmetric) for FIR design.
- ``design_fir``: windowed-sinc, linear phase; ``cutoff`` is in units of
  the Nyquist frequency (scipy.signal.firwin-compatible); passband gain
  normalized to 1 at the band center (``scale=True`` semantics).
- ``fir_direct``: causal convolution, y[n] = sum_t h[t]*x[n-t],
  output length == len(x) (streaming C loop structure).
- ``overlap_save``: identical output to ``fir_direct`` (same length,
  causal); block size B = nfft - (numtaps-1).
- ``resample_poly``: causal polyphase; y[j] = sum_k h[p_j + up*k] * x[m_j - k]
  with j*down = m_j*up + p_j.  Output length = ceil(len(x)*up/down).
  ``zero_phase=True`` advances the output by the filter group delay
  (matches scipy.signal.resample_poly when given the same window).
- ``stft``: frame k = x[k*hop : k*hop+nfft] (no center padding, no partial
  frames — C-style), windowed, rfft.  num_frames = 1 + (len(x)-nfft)//hop.
- ``istft``: WOLA — overlap-add of w * irfft(S[k]) normalized by
  sum-of-squared-windows, clamped below at ``WOLA_EDGE_REL`` (1e-3) of
  its peak (absolute floor 1e-12).  Output length
  = nfft + (num_frames-1)*hop.  The relative clamp tapers the few edge
  samples whose window coverage is < 0.1 % of the interior instead of
  dividing by w[i]^2 ~ 1e-10 there: for MODIFIED spectra (gate masks,
  vocoder) the frame content is no longer window-shaped and that
  division amplifies residual noise by up to 1/w[i] ~ 1e5 — a full-scale
  click at both file edges.  Exact reconstruction of unmodified spectra
  is unaffected except at those same tapered samples.
- ``envelope``: full-wave rectify -> causal FIR lowpass, scaled by pi/2
  (sine-carrier amplitude calibration).
- ``noise_gate``: per-bin noise floor = mean |STFT| over the first
  ``noise_frames`` frames; hard mask with ``10**(-reduction_db/20)``
  attenuation below floor*10**(threshold_db/20); optional max-with-decay
  release smoothing of the mask along frames.
- phase vocoder: analysis hop = synthesis hop = ``hop``; time positions
  t_k = k*rate (in frames) with linear magnitude interpolation and phase
  accumulation of the deviation-corrected instantaneous frequency.
"""

from __future__ import annotations

import numpy as np
from audiosignalprocess_tpu.utils.validate import check

# --------------------------------------------------------------------------
# Windows
# --------------------------------------------------------------------------


def window(kind: str, n: int, periodic: bool = True) -> np.ndarray:
    """Window function, float64.  kind in {rect, hann, hamming, blackman}."""
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    if n == 1 and not periodic:
        # scipy convention: a 1-point symmetric window is [1.0] (the
        # 0/0 midpoint), so design_fir(numtaps=1) is the identity tap
        return np.ones(1, dtype=np.float64)
    denom = n if periodic else n - 1
    t = np.arange(n, dtype=np.float64)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * t / denom)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * t / denom)
    if kind == "blackman":
        return (
            0.42
            - 0.5 * np.cos(2.0 * np.pi * t / denom)
            + 0.08 * np.cos(4.0 * np.pi * t / denom)
        )
    raise ValueError(f"unknown window kind: {kind!r}")


# --------------------------------------------------------------------------
# FFT family (structural references: radix-2 w/ bit reversal, split-radix)
# --------------------------------------------------------------------------


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation for power-of-two n."""
    bits = int(n).bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def fft_radix2(x: np.ndarray) -> np.ndarray:
    """Iterative radix-2 DIT FFT with explicit bit-reversal, batched on the
    last axis.  Matches the classic in-place C structure."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    check(n & (n - 1) == 0, "radix-2 FFT requires power-of-two length")
    y = x[..., bit_reverse_indices(n)].copy()
    m = 1
    while m < n:
        # butterflies of half-size m, group size 2m
        w = np.exp(-2j * np.pi * np.arange(m) / (2 * m))
        yv = y.reshape(y.shape[:-1] + (n // (2 * m), 2, m))
        a = yv[..., 0, :]
        b = yv[..., 1, :] * w
        y = np.concatenate([a + b, a - b], axis=-1).reshape(y.shape[:-1] + (n,))
        m *= 2
    return y


def _fft_splitradix_rec(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    if n == 1:
        return x
    if n == 2:
        return np.stack([x[..., 0] + x[..., 1], x[..., 0] - x[..., 1]], axis=-1)
    # split-radix: even half (N/2), odd quarters x[4k+1], x[4k+3] (N/4 each)
    u = _fft_splitradix_rec(x[..., 0::2])
    z = _fft_splitradix_rec(x[..., 1::4])
    zp = _fft_splitradix_rec(x[..., 3::4])
    k = np.arange(n // 4)
    w1 = np.exp(-2j * np.pi * k / n)
    w3 = np.exp(-2j * np.pi * 3 * k / n)
    zw = z * w1
    zpw = zp * w3
    s = zw + zpw
    d = -1j * (zw - zpw)  # L-shaped butterfly cross term
    uk = u[..., : n // 4]
    ukq = u[..., n // 4 : n // 2]
    out = np.empty(x.shape[:-1] + (n,), dtype=np.complex128)
    out[..., 0 : n // 4] = uk + s
    out[..., n // 4 : n // 2] = ukq + d
    out[..., n // 2 : 3 * n // 4] = uk - s
    out[..., 3 * n // 4 :] = ukq - d
    return out


def fft_splitradix(x: np.ndarray) -> np.ndarray:
    """Split-radix FFT (L-shaped butterflies), batched on the last axis."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    check(n & (n - 1) == 0, "power-of-two length required")
    return _fft_splitradix_rec(x)


def ifft_radix2(x: np.ndarray) -> np.ndarray:
    """Inverse via conjugate trick, scaled 1/N (C convention)."""
    n = x.shape[-1]
    return np.conj(fft_radix2(np.conj(x))) / n


def rfft(x: np.ndarray) -> np.ndarray:
    """Real FFT via N/2-point complex FFT + untangle.  Returns N/2+1 bins."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    check(n & (n - 1) == 0 and n >= 2, "power-of-two length >= 2 required")
    z = x[..., 0::2] + 1j * x[..., 1::2]  # length n/2 complex
    zf = fft_radix2(z)
    half = n // 2
    # Zk for k=0..half (wrap k=half -> Z0)
    zk = np.concatenate([zf, zf[..., :1]], axis=-1)
    zkc = np.conj(zk[..., ::-1])  # conj(Z[half-k])
    xe = 0.5 * (zk + zkc)
    xo = -0.5j * (zk - zkc)
    w = np.exp(-2j * np.pi * np.arange(half + 1) / n)
    return xe + w * xo


def irfft(spec: np.ndarray, n: int) -> np.ndarray:
    """Inverse real FFT: n real samples from n/2+1 bins, 1/N scaling."""
    spec = np.asarray(spec, dtype=np.complex128)
    half = n // 2
    # re-tangle into the half-size complex spectrum
    zk = spec[..., : half + 1]
    zkc = np.conj(zk[..., ::-1])
    xe = 0.5 * (zk + zkc)
    xo = 0.5 * (zk - zkc) * np.exp(2j * np.pi * np.arange(half + 1) / n)
    z = (xe + 1j * xo)[..., :half]
    zt = np.conj(fft_radix2(np.conj(z))) / half  # half-size ifft
    out = np.empty(spec.shape[:-1] + (n,), dtype=np.float64)
    out[..., 0::2] = zt.real
    out[..., 1::2] = zt.imag
    return out


# --------------------------------------------------------------------------
# FIR design + filtering
# --------------------------------------------------------------------------


def design_fir(
    numtaps: int,
    cutoff,
    window_kind: str = "hann",
    pass_zero: bool = True,
) -> np.ndarray:
    """Windowed-sinc linear-phase FIR design (firwin-compatible).

    cutoff: scalar (lowpass/highpass) or pair (bandpass/bandstop), in units
    of the Nyquist frequency.  pass_zero=True -> lowpass/bandstop;
    pass_zero=False -> highpass/bandpass.  Gain normalized to 1 at the band
    center (DC for pass_zero, band midpoint or Nyquist otherwise).
    """
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64))
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoff must be in (0, 1) (Nyquist units)")
    # band edges [0, c0, c1, ..., 1]; alternate stop/pass starting per pass_zero
    bands = np.concatenate([[0.0], cutoff, [1.0]])
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps, dtype=np.float64)
    passband = pass_zero
    scale_freq = None
    for lo, hi in zip(bands[:-1], bands[1:]):
        if passband:
            # ideal bandpass [lo, hi): hi*sinc(hi*m) - lo*sinc(lo*m)
            h += hi * np.sinc(hi * m) - lo * np.sinc(lo * m)
            if scale_freq is None:
                scale_freq = 0.0 if lo == 0.0 else (1.0 if hi == 1.0 else 0.5 * (lo + hi))
        passband = not passband
    w = window(window_kind, numtaps, periodic=False)
    h *= w
    # normalize passband center gain to 1
    c = np.cos(np.pi * m * scale_freq)
    s = np.sum(h * c)
    if abs(s) < 1e-8 * max(np.abs(h).max(), 1e-300) * numtaps:
        # e.g. even numtaps with gain at Nyquist (type-II highpass): the
        # normalization frequency has ~zero response; scipy.firwin raises
        # for the same designs
        raise ValueError(
            f"invalid FIR design: numtaps={numtaps} has ~zero gain at the "
            f"normalization frequency (use odd numtaps for highpass/bandstop)"
        )
    h /= s
    return h


def fir_direct(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Causal direct-form FIR, output length == len(x)."""
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    full = np.convolve(x, h)
    return full[: x.shape[-1]]


def overlap_save(x: np.ndarray, h: np.ndarray, nfft: int) -> np.ndarray:
    """Overlap-save fast convolution.  Identical output to fir_direct.

    Block size B = nfft - (T-1); each block's input is the previous T-1
    samples followed by B new samples; the first T-1 outputs of each block
    are discarded.
    """
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    check(nfft > t - 1 and nfft >= 1,
          f"nfft={nfft} too small for {t} taps (need nfft > taps-1)")
    b = nfft - (t - 1)
    n = len(x)
    nblocks = -(-n // b)  # ceil
    xp = np.concatenate([np.zeros(t - 1), x, np.zeros(nblocks * b - n)])
    hf = rfft(np.concatenate([h, np.zeros(nfft - t)]))
    out = np.empty(nblocks * b, dtype=np.float64)
    for k in range(nblocks):
        seg = xp[k * b : k * b + nfft]
        y = irfft(rfft(seg) * hf, nfft)
        out[k * b : (k + 1) * b] = y[t - 1 :]
    return out[:n]


# --------------------------------------------------------------------------
# Polyphase rational resampler
# --------------------------------------------------------------------------


def resample_filter(up: int, down: int, half_width: int = 10,
                    window_kind: str = "hann") -> np.ndarray:
    """Prototype lowpass for up/down resampling: windowed sinc at
    cutoff = 1/max(up, down) (Nyquist units of the upsampled rate), gain up.
    numtaps = 2*half_width*max(up, down) + 1 (odd, type I)."""
    m = max(up, down)
    numtaps = 2 * half_width * m + 1
    h = design_fir(numtaps, 1.0 / m, window_kind=window_kind)
    return h * up


def resample_poly(
    x: np.ndarray,
    up: int,
    down: int,
    h: np.ndarray | None = None,
    zero_phase: bool = True,
) -> np.ndarray:
    """Polyphase rational resampler.

    Conceptually: zero-stuff by `up`, filter with h, take every `down`-th
    sample.  Causal form: y[j] = sum_k h[p_j + up*k] * x[m_j - k] where
    j*down = m_j*up + p_j.  zero_phase=True shifts by the filter group
    delay (h must be odd-length / type I), matching
    scipy.signal.resample_poly given the same window.
    Output length = ceil(len(x)*up/down).
    """
    from math import gcd

    g = gcd(up, down)
    up, down = up // g, down // g
    x = np.asarray(x, dtype=np.float64)
    if up == 1 and down == 1:
        return x.copy()
    if h is None:
        h = resample_filter(up, down)
    h = np.asarray(h, dtype=np.float64)
    n = x.shape[-1]
    nout = -(-n * up // down)  # ceil
    delay = (len(h) - 1) // 2 if zero_phase else 0
    j = np.arange(nout)
    pos = j * down + delay  # position in the upsampled/filtered stream
    m = pos // up  # newest input sample index
    p = pos - m * up  # polyphase phase = pos % up
    nk = -(-(len(h)) // up)  # taps per phase (ceil)
    out = np.zeros(nout, dtype=np.float64)
    for k in range(nk):
        tap = p + up * k  # h index
        xi = m - k  # x index
        valid = (tap < len(h)) & (xi >= 0) & (xi < n)
        hv = np.where(tap < len(h), h[np.minimum(tap, len(h) - 1)], 0.0)
        xv = np.where((xi >= 0) & (xi < n), x[np.clip(xi, 0, n - 1)], 0.0)
        out += np.where(valid, hv * xv, 0.0)
    return out


# --------------------------------------------------------------------------
# STFT / ISTFT
# --------------------------------------------------------------------------


def stft(x: np.ndarray, nfft: int, hop: int, window_kind: str = "hann") -> np.ndarray:
    """STFT: frames at k*hop, no padding; returns (num_frames, nfft//2+1)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    check(n >= nfft, "signal shorter than one frame")
    nframes = 1 + (n - nfft) // hop
    w = window(window_kind, nfft, periodic=True)
    idx = np.arange(nfft)[None, :] + hop * np.arange(nframes)[:, None]
    frames = x[..., idx] * w
    return rfft(frames)


WOLA_EDGE_REL = 1e-3
"""Relative WOLA-normalization clamp: norm values below this fraction of
the norm's peak divide by the clamp instead (module docstring, istft)."""


def wola_clamp(norm: np.ndarray) -> np.ndarray:
    """Clamped WOLA norm per the pinned convention (float64)."""
    return np.maximum(norm, max(WOLA_EDGE_REL * float(np.max(norm)), 1e-12))


def istft(spec: np.ndarray, nfft: int, hop: int, window_kind: str = "hann") -> np.ndarray:
    """WOLA inverse STFT.  Output length = nfft + (frames-1)*hop."""
    spec = np.asarray(spec, dtype=np.complex128)
    nframes = spec.shape[-2]
    w = window(window_kind, nfft, periodic=True)
    frames = irfft(spec, nfft) * w
    nout = nfft + (nframes - 1) * hop
    y = np.zeros(spec.shape[:-2] + (nout,), dtype=np.float64)
    norm = np.zeros(nout, dtype=np.float64)
    for k in range(nframes):
        y[..., k * hop : k * hop + nfft] += frames[..., k, :]
        norm[k * hop : k * hop + nfft] += w * w
    return y / wola_clamp(norm)


# --------------------------------------------------------------------------
# Effects
# --------------------------------------------------------------------------


def envelope(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Envelope follower: full-wave rectify -> causal FIR lowpass, * pi/2."""
    return fir_direct(np.abs(np.asarray(x, dtype=np.float64)), h) * (np.pi / 2.0)


def am_demod(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """AM demodulation: envelope with DC (carrier) removed by mean."""
    e = envelope(x, h)
    return e - np.mean(e)


def hilbert_envelope(x: np.ndarray) -> np.ndarray:
    """|analytic signal| via rfft spectrum doubling (len must be pow2)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    spec = rfft(x)
    full = np.zeros(x.shape[:-1] + (n,), dtype=np.complex128)
    full[..., 0] = spec[..., 0]
    full[..., n // 2] = spec[..., n // 2]
    full[..., 1 : n // 2] = 2.0 * spec[..., 1 : n // 2]
    analytic = np.conj(fft_radix2(np.conj(full))) / n
    return np.abs(analytic)


def noise_gate(
    x: np.ndarray,
    nfft: int = 1024,
    hop: int = 256,
    threshold_db: float = 6.0,
    reduction_db: float = 60.0,
    noise_frames: int = 8,
    release: float = 0.0,
    window_kind: str = "hann",
) -> np.ndarray:
    """Spectral noise gate: per-bin floor from the first noise_frames frames,
    hard mask with `reduction_db` attenuation, optional max-with-decay release
    smoothing of the mask along frames, WOLA resynthesis.
    Output length = istft length for the analyzed frames."""
    spec = stft(x, nfft, hop, window_kind)
    mag = np.abs(spec)
    floor = np.mean(mag[..., :noise_frames, :], axis=-2, keepdims=True)
    thresh = floor * (10.0 ** (threshold_db / 20.0))
    att = 10.0 ** (-reduction_db / 20.0)
    mask = np.where(mag > thresh, 1.0, att)
    if release > 0.0:
        # release smoothing: s_k = max(mask_k, release * s_{k-1}) — a
        # max-with-decay recurrence (associative, scan-friendly on device)
        out = np.empty_like(mask)
        state = np.zeros_like(mask[..., 0, :])
        for k in range(mask.shape[-2]):
            state = np.maximum(mask[..., k, :], release * state)
            out[..., k, :] = state
        mask = out
    return istft(spec * mask, nfft, hop, window_kind)


def time_stretch(
    x: np.ndarray,
    rate: float,
    nfft: int = 1024,
    hop: int = 256,
    window_kind: str = "hann",
) -> np.ndarray:
    """Phase-vocoder time stretch (rate > 1 speeds up).

    Output frame t samples analysis position t*rate (frames), linear
    magnitude interpolation, accumulated deviation-corrected phase."""
    spec = stft(x, nfft, hop, window_kind)
    nframes = spec.shape[-2]
    steps = np.arange(0, nframes - 1, rate)
    nbins = spec.shape[-1]
    omega = 2.0 * np.pi * np.arange(nbins) * hop / nfft  # expected advance
    out = np.empty(spec.shape[:-2] + (len(steps), nbins), dtype=np.complex128)
    phase = np.angle(spec[..., 0, :])
    for i, s in enumerate(steps):
        k = int(np.floor(s))
        frac = s - k
        mag = (1 - frac) * np.abs(spec[..., k, :]) + frac * np.abs(spec[..., k + 1, :])
        out[..., i, :] = mag * np.exp(1j * phase)
        dphi = np.angle(spec[..., k + 1, :]) - np.angle(spec[..., k, :]) - omega
        dphi -= 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))
        adv = omega + dphi
        # accumulate mod 2*pi: the dropped term is an exact integer
        # multiple of 2*pi (phase only matters mod 2*pi), and the running
        # sum stays O(pi * frames) instead of O(omega * frames) — in f32
        # implementations the unwrapped sum reaches ~1e5 rad and loses
        # ~all mantissa (measured 45 dB stream-vs-full); wrapped, ~90 dB.
        phase += adv - 2.0 * np.pi * np.round(adv / (2.0 * np.pi))
    return istft(out, nfft, hop, window_kind)


def pitch_shift(
    x: np.ndarray,
    semitones: float,
    nfft: int = 1024,
    hop: int = 256,
    window_kind: str = "hann",
    resample_quant: int = 128,
) -> np.ndarray:
    """Pitch shift = time stretch by `factor` + polyphase resample back.

    The resample ratio is quantized to a rational with denominator
    <= resample_quant (polyphase requires integer up/down)."""
    from fractions import Fraction

    factor = 2.0 ** (semitones / 12.0)
    fr = Fraction(factor).limit_denominator(resample_quant)
    up, down = fr.denominator, fr.numerator  # resample by 1/factor
    y = time_stretch(x, 1.0 / factor, nfft, hop, window_kind)
    return resample_poly(y, up, down)


# --------------------------------------------------------------------------
# Utility
# --------------------------------------------------------------------------


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB (ref vs test, same shape)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    err = ref - test
    p_sig = np.sum(ref * ref)
    p_err = np.sum(err * err)
    if p_err == 0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)
