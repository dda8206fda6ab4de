"""End-to-end config tests (SURVEY.md §4.5): the five driver configs
(BASELINE.json:7-11) on WAV fixtures, SNR-checked against the oracle chain."""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.io.wav import read_wav, write_wav
from audiosignalprocess_tpu.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.ops.resample import resample_poly
from audiosignalprocess_tpu.pipeline import (
    Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tone_noise(channels, rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal((channels, n))
    for c in range(channels):
        f = 220.0 * 2.0 ** (c % 12 / 12)
        x[c] += np.where((t > 0.25 * seconds) & (t < 0.7 * seconds),
                         0.5 * np.sin(2 * np.pi * f * t), 0.0)
    return x.astype(np.float32)


class TestConfig1:
    def test_wav_roundtrip_chain(self):
        """Config 1: mono 16 kHz -> 64-tap FIR overlap-save -> WAV, parity."""
        x = _tone_noise(1, 16000, 2.0)
        h = design_fir(64, 0.25)
        with tempfile.TemporaryDirectory() as d:
            inp = os.path.join(d, "in.wav")
            outp = os.path.join(d, "out.wav")
            write_wav(inp, x, 16000, float_fmt=True)
            y, rate = read_wav(inp)
            out = np.asarray(overlap_save(y, h, 1024))
            write_wav(outp, out, rate, float_fmt=True)
            back, _ = read_wav(outp, dtype=np.float64)
        ref = oracle.overlap_save(x[0].astype(np.float64), h, 1024)
        assert back.shape == (1, ref.shape[0])
        assert oracle.snr_db(ref, back[0]) >= 60.0

    def test_cli(self):
        """The actual driver script runs and asserts parity itself."""
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "run_config_1.py"),
             "--json", "--seconds", "1"],
            capture_output=True, text=True, timeout=1200, env=env,
            # the driver itself forces parity (config 1 is the parity config)
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"parity": true' in r.stdout, r.stdout


class TestConfig2:
    def test_resample_bandpass(self):
        x = _tone_noise(2, 44100, 1.0)
        h = design_fir(256, (0.1, 0.5), window_kind="hamming", pass_zero=False)
        out = np.asarray(fir_direct(resample_poly(x, 160, 147), h))
        ref = np.stack([
            oracle.fir_direct(oracle.resample_poly(x[c].astype(np.float64), 160, 147), h)
            for c in range(2)
        ])
        assert out.shape == ref.shape
        assert oracle.snr_db(ref, out) >= 60.0


class TestConfig3:
    def test_channel_sharded_gate(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 virtual devices")
        from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
        from audiosignalprocess_tpu.parallel.sharded import sharded_noise_gate

        x = _tone_noise(8, 48000, 1.0)
        n = (x.shape[-1] // 256) * 256
        x = x[:, :n].astype(np.float64)
        mesh = make_mesh(channel=8, time=1)
        out = np.asarray(sharded_noise_gate(mesh)(shard_audio(x, mesh)))
        ref = np.stack([oracle.noise_gate(x[c]) for c in range(8)])
        assert oracle.snr_db(ref, out[:, : ref.shape[-1]]) >= 60.0


class TestConfig4:
    def test_long_fir_halo(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 virtual devices")
        from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
        from audiosignalprocess_tpu.parallel.sharded import sharded_overlap_save

        x = _tone_noise(4, 96000, 1.0).astype(np.float64)
        n = (x.shape[-1] // 8192) * 8192
        x = x[:, :n]
        h = design_fir(4096, 0.1, window_kind="blackman")
        mesh = make_mesh(channel=2, time=4)
        out = np.asarray(sharded_overlap_save(mesh, h, 16384)(shard_audio(x, mesh)))
        ref = np.stack([oracle.fir_direct(x[c], h) for c in range(4)])
        assert oracle.snr_db(ref, out) >= 60.0


class TestConfig5:
    def test_streaming_full_chain(self):
        block = 147 * 16
        x = _tone_noise(4, 44100, 1.0)[:, : block * 6]
        chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=design_fir(64, 0.3), nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
            EnvelopeStage(design_fir(129, 0.01)),
        ])
        lat = chain.build()
        full = np.asarray(chain.full(x))
        streamed = np.asarray(chain.stream(x, block))
        got = streamed[..., lat:]
        want = full[..., : got.shape[-1]]
        # f32 through a 4-stage chain accumulates ~1e-5 roundoff between
        # the two (algebraically identical) execution orders; the spec
        # bound is SNR-based (BASELINE.json:5).
        assert oracle.snr_db(want.astype(np.float64), got.astype(np.float64)) >= 80.0


class TestConfig5Ring:
    def test_ring_equals_stream_and_restart(self):
        """Ring-buffer streaming (native decode thread -> SPSC ring ->
        jitted step) == lax.scan streaming; restart-from-block via the
        carry checkpoint reproduces the tail exactly (BASELINE.json:11)."""
        import importlib

        sys.path.insert(0, os.path.join(REPO, "tools"))
        run_config_5 = importlib.import_module("run_config_5")

        block = 147 * 8
        x = _tone_noise(4, 44100, 1.0)[:, : block * 8]
        chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=design_fir(64, 0.3), nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        chain.build()
        with tempfile.TemporaryDirectory() as d:
            wav = os.path.join(d, "in.wav")
            write_wav(wav, x, 44100, float_fmt=True)
            out, nb, _ = run_config_5.run_ring(chain, wav, block, 4)
            assert nb == 8
            ref = np.asarray(jax.jit(lambda v: chain.stream(v, block))(x))
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
            # restart-from-block: checkpoint at block 4, resume, tail equal
            ck = os.path.join(d, "carry.npz")
            out_a, _, _ = run_config_5.run_ring(chain, wav, block, 4,
                                             ckpt=(ck, 4))
            out_b, _, _ = run_config_5.run_ring(chain, wav, block, 4, resume=ck)
            tail = out_a[..., 4 * chain.out_block(block):]
            np.testing.assert_array_equal(tail, out_b)

    def test_ring_composite_one_kernel_chain(self):
        """Ring streaming x micro-batching x the composite stage with its
        envelope: the full resample+FIR+gate+envelope chain as one stage
        behind the ring matches Chain.stream."""
        import importlib

        from audiosignalprocess_tpu.pipeline import ResFIRGateStage

        sys.path.insert(0, os.path.join(REPO, "tools"))
        run_config_5 = importlib.import_module("run_config_5")

        block = 2 * 1176  # 2x the res-step quantum for 160/147 @ 1024/256
        x = _tone_noise(4, 44100, 1.0)[:, : block * 6]
        chain = Chain([ResFIRGateStage(
            up=160, down=147, h=design_fir(64, 0.3), nfft=1024, hop=256,
            noise_frames=4, env_h=design_fir(129, 0.05))])
        chain.build()
        st = chain.init_state((4,), block, jax.numpy.float32)
        assert len(st[0][1]) == 3  # FIR, gate and envelope carries
        with tempfile.TemporaryDirectory() as d:
            wav = os.path.join(d, "in.wav")
            write_wav(wav, x, 44100, float_fmt=True)
            out, nb, _ = run_config_5.run_ring(chain, wav, block, 4,
                                            batch_blocks=2)
            assert nb == 6
            ref = np.asarray(jax.jit(lambda v: chain.stream(v, block))(x))
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)

    def test_ring_micro_batched(self):
        """batch_blocks=K pops K blocks per device call and scans
        chain.step over them in ONE jit — same carry semantics, so the
        output matches Chain.stream; the checkpoint boundary splits a
        batch (3+1 | 3+1 for K=3, ckpt at 4) and the resumed tail is
        bit-identical."""
        import importlib

        sys.path.insert(0, os.path.join(REPO, "tools"))
        run_config_5 = importlib.import_module("run_config_5")

        block = 147 * 8
        x = _tone_noise(4, 44100, 1.0)[:, : block * 8]
        chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=design_fir(64, 0.3), nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        chain.build()
        with tempfile.TemporaryDirectory() as d:
            wav = os.path.join(d, "in.wav")
            write_wav(wav, x, 44100, float_fmt=True)
            # 8 blocks at K=3: full batches 3+3, single-step tail 1+1
            out, nb, _ = run_config_5.run_ring(chain, wav, block, 4,
                                            batch_blocks=3)
            assert nb == 8
            ref = np.asarray(jax.jit(lambda v: chain.stream(v, block))(x))
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
            ck = os.path.join(d, "carry.npz")
            out_a, _, _ = run_config_5.run_ring(chain, wav, block, 4,
                                             ckpt=(ck, 4), batch_blocks=3)
            out_b, _, _ = run_config_5.run_ring(chain, wav, block, 4,
                                             resume=ck, batch_blocks=3)
            tail = out_a[..., 4 * chain.out_block(block):]
            np.testing.assert_array_equal(tail, out_b)
