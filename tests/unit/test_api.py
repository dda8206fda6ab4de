"""File-level one-shot API tests (SURVEY.md §1a drivers layer)."""

import os

import numpy as np
import pytest

from audiosignalprocess_tpu import api
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.io.wav import read_wav, write_wav


@pytest.fixture()
def tone_wav(tmp_path):
    fs = 16000
    t = np.arange(32000) / fs
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.4 * np.sin(2 * np.pi * 6000 * t)
    p = str(tmp_path / "in.wav")
    write_wav(p, x.astype(np.float32), fs, float_fmt=True)
    return p, fs, x


def _peak_ratio(y, fs, f_keep, f_cut):
    seg = y[4000:4000 + 8192] * np.hanning(8192)
    spec = np.abs(np.fft.rfft(seg))
    f = np.fft.rfftfreq(8192, 1 / fs)
    return (spec[np.argmin(abs(f - f_cut))] /
            spec[np.argmin(abs(f - f_keep))])


def test_lowpass_file(tone_wav, tmp_path):
    p, fs, x = tone_wav
    out = str(tmp_path / "lp.wav")
    shape = api.lowpass_file(p, out, cutoff_hz=2000, **{"float_fmt": True})
    y, rate = read_wav(out, dtype=np.float64)
    assert rate == fs and y.shape == (1, 32000) == (shape[0], shape[1])
    assert _peak_ratio(y[0], fs, 440, 6000) < 1e-2


def test_bandpass_file(tone_wav, tmp_path):
    p, fs, x = tone_wav
    out = str(tmp_path / "bp.wav")
    api.bandpass_file(p, out, 4000, 7500, **{"float_fmt": True})
    y, _ = read_wav(out, dtype=np.float64)
    assert _peak_ratio(y[0], fs, 6000, 440) < 1e-2  # 440 cut, 6000 kept


def test_resample_file(tone_wav, tmp_path):
    p, fs, x = tone_wav
    out = str(tmp_path / "rs.wav")
    api.resample_file(p, out, 48000, **{"float_fmt": True})
    y, rate = read_wav(out)
    assert rate == 48000
    assert y.shape[-1] == -(-32000 * 48000 // 16000)


def test_noise_gate_file(tmp_path):
    fs = 48000
    rng = np.random.default_rng(0)
    n = 48128
    x = 0.01 * rng.standard_normal(n)
    x[16000:32000] += np.sin(2 * np.pi * 440 * np.arange(16000) / fs)
    p = str(tmp_path / "in.wav")
    write_wav(p, x.astype(np.float32), fs, float_fmt=True)
    out = str(tmp_path / "ng.wav")
    api.noise_gate_file(p, out, **{"float_fmt": True})
    y, _ = read_wav(out, dtype=np.float64)
    assert np.std(y[0, 2000:12000]) < 0.5 * np.std(x[2000:12000])
    assert np.std(y[0, 18000:30000]) > 0.8 * np.std(x[18000:30000])


def test_pitch_shift_file(tone_wav, tmp_path):
    p, fs, _ = tone_wav
    out = str(tmp_path / "ps.wav")
    api.pitch_shift_file(p, out, semitones=12.0)
    y, _ = read_wav(out, dtype=np.float64)
    seg = y[0, 8192:8192 + 8192] * np.hanning(8192)
    spec = np.abs(np.fft.rfft(seg))
    f = np.fft.rfftfreq(8192, 1 / fs)
    # 440 -> 880 present
    assert spec[np.argmin(abs(f - 880))] > 5 * spec[np.argmin(abs(f - 440))]


def test_time_stretch_file(tone_wav, tmp_path):
    p, fs, _ = tone_wav
    out = str(tmp_path / "ts.wav")
    api.time_stretch_file(p, out, rate_factor=2.0)
    y, _ = read_wav(out)
    assert 0.4 < y.shape[-1] / 32000 < 0.6


def test_chain_file(tmp_path):
    """The flagship one-call chain (config 5 as a library function):
    resample 44.1->48k + lowpass + gate (+ envelope), whole-file and
    block streaming, against the composed oracle chain."""
    fs = 44100
    rng = np.random.default_rng(3)
    n = 588 * 120  # resampled length row-aligned
    x = 0.01 * rng.standard_normal(n)
    x[20000:50000] += np.sin(2 * np.pi * 440 * np.arange(30000) / fs)
    p = str(tmp_path / "in.wav")
    write_wav(p, x.astype(np.float32), fs, float_fmt=True)

    out = str(tmp_path / "chain.wav")
    shape = api.chain_file(p, out, rate_out=48000, noise_frames=4,
                           float_fmt=True)
    y, rate = read_wav(out, dtype=np.float64)
    assert rate == 48000 and y.shape == tuple(shape)
    ref = oracle.noise_gate(
        oracle.fir_direct(
            oracle.resample_poly(x.astype(np.float64), 160, 147,
                                 zero_phase=False),
            oracle.design_fir(64, 0.3)),
        noise_frames=4)
    m = min(y.shape[-1], ref.shape[-1])
    assert oracle.snr_db(ref[:m], y[0, :m]) >= 60.0

    # streaming block path + envelope
    out2 = str(tmp_path / "chain_env.wav")
    api.chain_file(p, out2, rate_out=48000, noise_frames=4,
                   envelope_hz=50.0, block=2 * 1176, float_fmt=True)
    y2, _ = read_wav(out2, dtype=np.float64)
    ref2 = oracle.fir_direct(np.abs(ref), oracle.design_fir(
        129, 2.0 * 50.0 / 48000)) * (np.pi / 2.0)
    # drained streaming contract: output is latency-stripped and aligned
    # to position 0 (api.chain_file block= streams with drain=True), so
    # emitted[i] == full[i] directly and the lengths match the rate map
    assert y2.shape[-1] == y.shape[-1]
    m2 = min(y2.shape[-1], ref2.shape[-1]) - 1024
    assert oracle.snr_db(ref2[:m2], y2[0, :m2]) >= 60.0


def test_chain_file_already_at_rate(tmp_path):
    """chain_file on a file ALREADY at rate_out: no resampler stage (a
    1/1 polyphase prototype has no valid cutoff — this crashed before),
    same lowpass+gate semantics, whole-file == streamed."""
    fs = 48000
    rng = np.random.default_rng(5)
    n = 48000 + 1234  # non-block-multiple exercises the drain path
    x = 0.01 * rng.standard_normal(n)
    x[10000:30000] += np.sin(2 * np.pi * 440 * np.arange(20000) / fs)
    p = str(tmp_path / "in48.wav")
    write_wav(p, x.astype(np.float32), fs, float_fmt=True)

    out = str(tmp_path / "full.wav")
    shape = api.chain_file(p, out, rate_out=48000, noise_frames=4,
                           float_fmt=True)
    y, rate = read_wav(out, dtype=np.float64)
    assert rate == 48000 and y.shape == tuple(shape)
    ref = oracle.noise_gate(
        oracle.fir_direct(x.astype(np.float64), oracle.design_fir(64, 0.3)),
        noise_frames=4)
    m = min(y.shape[-1], ref.shape[-1])
    assert oracle.snr_db(ref[:m], y[0, :m]) >= 60.0

    out2 = str(tmp_path / "blk.wav")
    api.chain_file(p, out2, rate_out=48000, noise_frames=4, block=2048,
                   float_fmt=True)
    y2, _ = read_wav(out2, dtype=np.float64)
    assert y2.shape == y.shape
    assert oracle.snr_db(y[0] + 1e-30, y2[0] + 1e-30) >= 60.0


def test_envelope_file(tmp_path):
    fs = 16000
    t = np.arange(16000) / fs
    x = (1.0 + 0.5 * np.sin(2 * np.pi * 5 * t)) * np.sin(2 * np.pi * 1000 * t)
    p = str(tmp_path / "am.wav")
    write_wav(p, x.astype(np.float32), fs, float_fmt=True)
    out = str(tmp_path / "env.wav")
    api.envelope_file(p, out, **{"float_fmt": True})
    y, _ = read_wav(out, dtype=np.float64)
    mod = 1.0 + 0.5 * np.sin(2 * np.pi * 5 * t)
    d = 64
    err = y[0, 2000:-2000] - mod[2000 - d: 16000 - 2000 - d]
    assert np.sqrt(np.mean(err ** 2)) < 0.05
