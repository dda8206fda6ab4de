"""File-level one-shot API (SURVEY.md §1a "Drivers" layer).

The reference repo's user surface is per-effect demo mains operating on
WAV files; these functions are that surface as a library: read a WAV,
run one effect (jit-compiled, oracle-pinned semantics), write a WAV.

    from audiosignalprocess_tpu import api
    api.lowpass_file("in.wav", "out.wav", cutoff_hz=2000)
    api.noise_gate_file("noisy.wav", "clean.wav")
    api.resample_file("cd.wav", "dat.wav", rate_out=48000)
    api.pitch_shift_file("voice.wav", "high.wav", semitones=4)
"""

from __future__ import annotations

from fractions import Fraction

import jax
import numpy as np

from audiosignalprocess_tpu.effects.envelope import envelope
from audiosignalprocess_tpu.effects.noise_gate import noise_gate
from audiosignalprocess_tpu.effects.phase_vocoder import pitch_shift, time_stretch
from audiosignalprocess_tpu.io.wav import read_wav, write_wav
from audiosignalprocess_tpu.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.ops.resample import resample_poly


def _process(path_in: str, path_out: str, make_fn, rate_out=None, **wav_kw):
    """Read -> jit(effect) -> write.  ``make_fn(rate)`` builds the effect
    for the file's sample rate (or pass a plain fn for rate-independent
    effects)."""
    x, rate = read_wav(path_in)
    fn = make_fn(rate) if _wants_rate(make_fn) else make_fn
    y = np.asarray(jax.jit(fn)(x))
    out_rate = rate_out(rate) if callable(rate_out) else (rate_out or rate)
    write_wav(path_out, y, out_rate, **wav_kw)
    return y.shape


def _wants_rate(f) -> bool:
    import inspect

    try:
        params = inspect.signature(f).parameters
    except (TypeError, ValueError):
        return False
    return "rate" in params


def lowpass_file(path_in: str, path_out: str, cutoff_hz: float,
                 numtaps: int = 64, nfft: int = 1024, **wav_kw):
    """Windowed-sinc FIR lowpass via overlap-save (config-1 chain)."""

    def make(rate):
        h = design_fir(numtaps, 2.0 * cutoff_hz / rate)
        return lambda v: overlap_save(v, h, nfft)

    return _process(path_in, path_out, make, **wav_kw)


def bandpass_file(path_in: str, path_out: str, lo_hz: float, hi_hz: float,
                  numtaps: int = 256, **wav_kw):
    """Windowed-sinc FIR bandpass (config-2 filter)."""

    def make(rate):
        h = design_fir(numtaps, (2.0 * lo_hz / rate, 2.0 * hi_hz / rate),
                       window_kind="hamming", pass_zero=False)
        return lambda v: fir_direct(v, h)

    return _process(path_in, path_out, make, **wav_kw)


def resample_file(path_in: str, path_out: str, rate_out: int, **wav_kw):
    """Polyphase rational resample to ``rate_out`` (e.g. 44100 -> 48000)."""

    def make(rate):
        fr = Fraction(rate_out, rate)
        return lambda v: resample_poly(v, fr.numerator, fr.denominator)

    return _process(path_in, path_out, make, rate_out=rate_out, **wav_kw)


def noise_gate_file(path_in: str, path_out: str, nfft: int = 1024,
                    hop: int = 256, threshold_db: float = 6.0,
                    reduction_db: float = 60.0, noise_frames: int = 8,
                    **wav_kw):
    """Spectral noise gate (config-3 effect)."""
    return _process(
        path_in, path_out,
        lambda v: noise_gate(v, nfft, hop, threshold_db, reduction_db,
                             noise_frames),
        **wav_kw,
    )


def envelope_file(path_in: str, path_out: str, cutoff_hz: float = 50.0,
                  numtaps: int = 129, **wav_kw):
    """Envelope follower / AM demodulation output."""

    def make(rate):
        h = design_fir(numtaps, 2.0 * cutoff_hz / rate)
        return lambda v: envelope(v, h)

    return _process(path_in, path_out, make, **wav_kw)


def time_stretch_file(path_in: str, path_out: str, rate_factor: float,
                      nfft: int = 1024, hop: int = 256, **wav_kw):
    """Phase-vocoder time stretch (rate_factor > 1 speeds up)."""
    return _process(
        path_in, path_out,
        lambda v: time_stretch(v, rate_factor, nfft, hop),
        **wav_kw,
    )


def pitch_shift_file(path_in: str, path_out: str, semitones: float,
                     nfft: int = 1024, hop: int = 256, **wav_kw):
    """Phase-vocoder pitch shift by ``semitones``."""
    return _process(
        path_in, path_out,
        lambda v: pitch_shift(v, semitones, nfft, hop),
        **wav_kw,
    )


def make_chain(rate_in: int, rate_out: int = 48000,
               cutoff_hz: float | None = None, numtaps: int = 64,
               nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, envelope_hz: float | None = None,
               env_numtaps: int = 129):
    """The flagship chain (config 5, BASELINE.json:11) for a file at
    ``rate_in``, built: resample to ``rate_out`` -> FIR lowpass
    (``cutoff_hz``, default 0.3*Nyquist) -> spectral noise gate ->
    optional envelope demod (``envelope_hz``), as one composite stage
    (``ResFIRGateStage``, or ``FIRGateStage`` when no resampling is
    needed)."""
    from audiosignalprocess_tpu.pipeline import (
        Chain, FIRGateStage, ResFIRGateStage,
    )

    fr = Fraction(rate_out, rate_in)
    fc = 2.0 * cutoff_hz / rate_out if cutoff_hz is not None else 0.3
    env_h = (design_fir(env_numtaps, 2.0 * envelope_hz / rate_out)
             if envelope_hz is not None else None)
    if fr == 1:
        # file already at rate_out: no resampler (a 1/1 polyphase stage
        # has no prototype filter — its cutoff would sit AT Nyquist)
        stage = FIRGateStage(
            h=design_fir(numtaps, fc), nfft=nfft, hop=hop,
            threshold_db=threshold_db, reduction_db=reduction_db,
            noise_frames=noise_frames, env_h=env_h)
    else:
        stage = ResFIRGateStage(
            up=fr.numerator, down=fr.denominator, h=design_fir(numtaps, fc),
            nfft=nfft, hop=hop, threshold_db=threshold_db,
            reduction_db=reduction_db, noise_frames=noise_frames, env_h=env_h)
    chain = Chain([stage])
    chain.build()
    return chain


def chain_file(path_in: str, path_out: str, rate_out: int = 48000,
               cutoff_hz: float | None = None, numtaps: int = 64,
               nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, envelope_hz: float | None = None,
               env_numtaps: int = 129, block: int | None = None, **wav_kw):
    """The flagship chain (``make_chain``) as one call on a WAV file,
    block-streamed when ``block`` is set (a multiple of the stage's input
    quantum; see ``ResFIRGateStage.init_state``) and whole-file
    otherwise."""
    x, rate = read_wav(path_in)
    chain = make_chain(rate, rate_out, cutoff_hz, numtaps, nfft, hop,
                       threshold_db, reduction_db, noise_frames,
                       envelope_hz, env_numtaps)
    # Both modes process the ENTIRE file (end-of-file flush) and emit
    # exactly chain.out_len(n) samples: streaming pads to whole blocks
    # internally and drains the carried latency, so block= changes the
    # execution schedule, never the output length or (beyond streaming
    # reassociation) the samples.
    if block is not None:
        y = np.asarray(
            jax.jit(lambda v: chain.stream(v, block, drain=True))(x))
    else:
        y = np.asarray(jax.jit(chain.full_flush)(x))
    write_wav(path_out, y, rate_out, **wav_kw)
    return y.shape
