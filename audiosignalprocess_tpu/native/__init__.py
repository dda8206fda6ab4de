"""Native C oracle (SURVEY.md §2 "Native-code components").

``asp_ref.c`` is the literal single-threaded C implementation of the
framework's DSP chain with the pinned conventions — the stand-in for the
reference C code (the reference mount was empty; SURVEY.md §0).  It is
compiled on demand with the system C compiler and bound via ctypes; the
numpy oracle (cpu_ref/oracle.py) and every JAX path are
cross-checked against it in tests/unit/test_native_oracle.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from audiosignalprocess_tpu.utils.validate import check

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "asp_ref.c")
_LIB = os.path.join(_DIR, "libasp_ref.so")

_lib = None


def _build() -> None:
    cmd = ["cc", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)


def lib() -> ctypes.CDLL:
    """Load (building if needed) the C oracle shared library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        _build()
    _lib = ctypes.CDLL(_LIB)
    return _lib


_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


_WIN = {"rect": 0, "hann": 1, "hamming": 2, "blackman": 3}


def _per_row(fn, x, *args):
    """Apply a 1-D wrapper over leading batch axes (the C kernels are
    single-signal; oracle parity tests batch)."""
    x = np.asarray(x)
    if x.ndim == 1:
        return fn(x, *args)
    rows = [_per_row(fn, r, *args) for r in x]
    return np.stack(rows)


def window(kind: str, n: int, periodic: bool = True) -> np.ndarray:
    out = np.empty(n)
    lib().asp_window(_WIN[kind], n, int(periodic), _dp(out))
    return out


def fft_radix2(x: np.ndarray) -> np.ndarray:
    def one(v):
        v = np.asarray(v, dtype=np.complex128)
        re = _c64(v.real).copy()
        im = _c64(v.imag).copy()
        lib().asp_fft_radix2(_dp(re), _dp(im), v.shape[-1], -1)
        return re + 1j * im

    return _per_row(one, x)


def ifft_radix2(x: np.ndarray) -> np.ndarray:
    def one(v):
        v = np.asarray(v, dtype=np.complex128)
        re = _c64(v.real).copy()
        im = _c64(v.imag).copy()
        lib().asp_ifft_radix2(_dp(re), _dp(im), v.shape[-1])
        return re + 1j * im

    return _per_row(one, x)


def fft_splitradix(x: np.ndarray) -> np.ndarray:
    def one(v):
        v = np.asarray(v, dtype=np.complex128)
        xr, xi = _c64(v.real), _c64(v.imag)
        yr, yi = np.empty_like(xr), np.empty_like(xi)
        lib().asp_fft_splitradix(_dp(xr), _dp(xi), v.shape[-1], _dp(yr), _dp(yi))
        return yr + 1j * yi

    return _per_row(one, x)


def rfft(x: np.ndarray) -> np.ndarray:
    def one(v):
        v = _c64(v)
        n = v.shape[-1]
        sr, si = np.empty(n // 2 + 1), np.empty(n // 2 + 1)
        lib().asp_rfft(_dp(v), n, _dp(sr), _dp(si))
        return sr + 1j * si

    return _per_row(one, x)


def irfft(spec: np.ndarray, n: int) -> np.ndarray:
    def one(v, nn):
        v = np.asarray(v, dtype=np.complex128)
        sr, si = _c64(v.real), _c64(v.imag)
        out = np.empty(nn)
        lib().asp_irfft(_dp(sr), _dp(si), nn, _dp(out))
        return out

    return _per_row(one, spec, n)


def design_fir(numtaps: int, cutoff, window_kind: str = "hann",
               pass_zero: bool = True) -> np.ndarray:
    c = np.atleast_1d(_c64(cutoff))
    h = np.empty(numtaps)
    rc = lib().asp_design_fir(numtaps, _dp(c), len(c), _WIN[window_kind],
                              int(pass_zero), _dp(h))
    if rc:
        raise ValueError(
            "invalid FIR design: ~zero gain at the normalization frequency "
            "(use odd numtaps for highpass/bandstop)"
        )
    return h


def fir_direct(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    def one(v, hh):
        v = _c64(v)
        y = np.empty_like(v)
        lib().asp_fir_direct(_dp(v), v.shape[-1], _dp(hh), len(hh), _dp(y))
        return y

    return _per_row(one, x, _c64(h))


def overlap_save(x: np.ndarray, h: np.ndarray, nfft: int) -> np.ndarray:
    def one(v, hh, nf):
        v = _c64(v)
        y = np.empty_like(v)
        lib().asp_overlap_save(_dp(v), v.shape[-1], _dp(hh), len(hh), nf, _dp(y))
        return y

    return _per_row(one, x, _c64(h), nfft)


def resample_poly(x: np.ndarray, up: int, down: int, h: np.ndarray,
                  zero_phase: bool = True) -> np.ndarray:
    from math import gcd

    g = gcd(up, down)
    up, down = up // g, down // g
    x, h = _c64(x), _c64(h)
    nout = -(-x.shape[-1] * up // down)
    y = np.empty(nout)
    lib().asp_resample_poly(_dp(x), x.shape[-1], up, down, _dp(h), len(h),
                            int(zero_phase), _dp(y), nout)
    return y


def stft(x: np.ndarray, nfft: int, hop: int, window_kind: str = "hann") -> np.ndarray:
    x = _c64(x)
    nframes = 1 + (x.shape[-1] - nfft) // hop
    bins = nfft // 2 + 1
    sr = np.empty((nframes, bins))
    si = np.empty((nframes, bins))
    lib().asp_stft(_dp(x), x.shape[-1], nfft, hop, _WIN[window_kind],
                   _dp(sr), _dp(si))
    return sr + 1j * si


def istft(spec: np.ndarray, nfft: int, hop: int, window_kind: str = "hann") -> np.ndarray:
    spec = np.asarray(spec, dtype=np.complex128)
    sr, si = _c64(spec.real), _c64(spec.imag)
    nframes = spec.shape[-2]
    y = np.empty(nfft + (nframes - 1) * hop)
    lib().asp_istft(_dp(sr), _dp(si), nframes, nfft, hop, _WIN[window_kind], _dp(y))
    return y


def envelope(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    def one(v, hh):
        v = _c64(v)
        y = np.empty_like(v)
        lib().asp_envelope(_dp(v), v.shape[-1], _dp(hh), len(hh), _dp(y))
        return y

    return _per_row(one, x, _c64(h))


def noise_gate(x: np.ndarray, nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, window_kind: str = "hann") -> np.ndarray:
    x = _c64(x)
    check(x.shape[-1] >= nfft,
          f"signal shorter than one frame (n={x.shape[-1]} < nfft={nfft})")
    check(noise_frames >= 1, "noise_frames must be >= 1")
    nframes = 1 + (x.shape[-1] - nfft) // hop
    y = np.empty(nfft + (nframes - 1) * hop)
    nout = ctypes.c_int(0)
    fn = lib().asp_noise_gate
    fn.argtypes = [_DP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.c_int, _DP, _IP]
    fn(_dp(x), x.shape[-1], nfft, hop, threshold_db, reduction_db,
       noise_frames, _WIN[window_kind], _dp(y), ctypes.byref(nout))
    check(nout.value >= 0, "native noise gate rejected the geometry")
    return y[: nout.value]
