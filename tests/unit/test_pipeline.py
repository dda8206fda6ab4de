"""Streaming pipeline tests: block-streamed output == whole-file output
(SURVEY.md §4.4, BASELINE.json:11 streaming chain)."""

import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.pipeline import (
    Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage,
)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(13)


def _stream_equals_full(chain: Chain, x: np.ndarray, block: int, rtol=1e-8, atol=1e-8):
    lat = chain.build()
    full = np.asarray(chain.full(x))
    streamed = np.asarray(chain.stream(x, block))
    # identity: streamed[L:] == full[:len(streamed)-L]
    got = streamed[..., lat:]
    want = full[..., : got.shape[-1]]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


class TestFIRStage:
    def test_stream_equals_full(self, rng):
        x = rng.standard_normal((2, 8192))
        h = oracle.design_fir(64, 0.25)
        _stream_equals_full(Chain([FIRStage(h=h)]), x, 1024)

    def test_overlap_save_stage(self, rng):
        x = rng.standard_normal(8192)
        h = oracle.design_fir(64, 0.25)
        _stream_equals_full(Chain([FIRStage(h=h, nfft=1024)]), x, 1024)

    def test_full_matches_oracle(self, rng):
        x = rng.standard_normal(4096)
        h = oracle.design_fir(64, 0.25)
        c = Chain([FIRStage(h=h, nfft=1024)])
        c.build()
        np.testing.assert_allclose(
            np.asarray(c.full(x)), oracle.fir_direct(x, h), rtol=1e-8, atol=1e-8
        )


class TestResampleStage:
    @pytest.mark.parametrize("up,down", ((160, 147), (1, 2), (3, 4)))
    def test_stream_equals_full(self, rng, up, down):
        block = down * 32
        x = rng.standard_normal((2, block * 8))
        _stream_equals_full(Chain([ResampleStage(up=up, down=down)]), x, block)


class TestEnvelopeStage:
    def test_stream_equals_full(self, rng):
        x = rng.standard_normal(8192)
        h = oracle.design_fir(129, 0.01)
        _stream_equals_full(Chain([EnvelopeStage(h)]), x, 512)


class TestGateStage:
    def test_stream_equals_full(self, rng):
        fs = 48000
        n = 512 * 96
        t = np.arange(n) / fs
        x = 0.01 * rng.standard_normal(n) + np.where(
            (t > 0.4) & (t < 0.7), np.sin(2 * np.pi * 440.0 * t), 0.0
        )
        _stream_equals_full(Chain([GateStage()]), x, 512)

    def test_full_matches_oracle_gate(self, rng):
        n = 48000
        x = 0.01 * rng.standard_normal(n)
        x[20000:30000] += np.sin(2 * np.pi * 440.0 * np.arange(10000) / 48000.0)
        g = GateStage()
        c = Chain([g])
        c.build()
        out = np.asarray(c.full(x))
        ref = oracle.noise_gate(x)
        np.testing.assert_allclose(out[: ref.shape[-1]], ref, rtol=1e-7, atol=1e-9)
        assert np.allclose(out[ref.shape[-1] :], 0.0)


class TestFullChain:
    def test_config5_chain_stream_equals_full(self, rng):
        """Streaming config-5-style chain: resample 160/147 -> FIR ->
        noise gate -> envelope (BASELINE.json:11)."""
        block = 147 * 16  # multiple of down and (after resample) of hop? 147*16*160/147=2560
        x = rng.standard_normal((2, block * 6))
        h_fir = oracle.design_fir(64, 0.3)
        h_env = oracle.design_fir(129, 0.01)
        chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=h_fir, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
            EnvelopeStage(h_env),
        ])
        _stream_equals_full(chain, x, block, rtol=1e-7, atol=1e-8)

    def test_checkpoint_resume(self, rng):
        """Stream halfway, checkpoint the carry, resume -> same output."""
        from audiosignalprocess_tpu.utils.checkpoint import load_carry, save_carry
        import tempfile, os, jax

        x = rng.standard_normal(8192)
        h = oracle.design_fir(64, 0.25)
        chain = Chain([FIRStage(h=h)])
        chain.build()
        block = 1024
        states = chain.init_state((), block, jax.numpy.float64)
        outs = []
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ck.npz")
            for k in range(4):
                states, y = chain.step(states, x[k * block : (k + 1) * block])
                outs.append(np.asarray(y))
            save_carry(path, states, block_index=4)
            states2, bk = load_carry(path, states)
            assert bk == 4
            for k in range(4, 8):
                states2, y = chain.step(states2, x[k * block : (k + 1) * block])
                outs.append(np.asarray(y))
        ref = np.asarray(chain.full(x))
        np.testing.assert_allclose(np.concatenate(outs), ref, rtol=1e-8, atol=1e-8)


class TestFusedStages:
    """One stage, two formulations: overlap-save vs direct form, and the
    default FFT (XLA's) vs the four-step matmul FFT."""

    def test_fir_stage_fused_matches(self, rng):
        x = rng.standard_normal((2, 8192)).astype(np.float32)
        h = oracle.design_fir(64, 0.25)
        a = Chain([FIRStage(h=h, nfft=1024)]); a.build()
        b = Chain([FIRStage(h=h)]); b.build()
        ya, yb = np.asarray(a.full(x)), np.asarray(b.full(x))
        assert oracle.snr_db(ya.astype(np.float64), yb.astype(np.float64)) >= 100.0

    def test_gate_stage_fused_matches(self, rng):
        x = (0.01 * rng.standard_normal((2, 48128))).astype(np.float32)
        x[:, 16000:32000] += np.sin(
            2 * np.pi * 440 * np.arange(16000) / 48000
        ).astype(np.float32)
        a = Chain([GateStage()]); a.build()
        b = Chain([GateStage(impl="matmul")]); b.build()
        ya, yb = np.asarray(a.full(x)), np.asarray(b.full(x))
        # both paths are f32 but run different FFT factorizations; the
        # gate's hard threshold can flip a borderline bin in one frame,
        # which caps cross-implementation agreement (~95 dB on this
        # input) well below what linear stages achieve.  Real breakage
        # (wrong framing/mask/norm) measures < 40 dB.
        assert oracle.snr_db(ya.astype(np.float64) + 1e-30,
                             yb.astype(np.float64) + 1e-30) >= 80.0

    @pytest.mark.parametrize("release", (0.0, 0.9))
    def test_gate_stage_fused_streaming(self, rng, release):
        """The streaming gate step with the matmul FFT tracks the default
        (XLA FFT) step, and its stream == full."""
        x = (0.01 * rng.standard_normal((2, 8192))).astype(np.float32)
        x[:, 2048:4096] += np.sin(np.arange(2048) / 10.0).astype(np.float32)
        ref = Chain([GateStage(release=release)])
        fus = Chain([GateStage(release=release, impl="matmul")])
        lat = ref.build(); fus.build()
        y_ref = np.asarray(ref.stream(x, 1024))
        y_fus = np.asarray(fus.stream(x, 1024))
        assert oracle.snr_db(y_ref.astype(np.float64) + 1e-30,
                             y_fus.astype(np.float64) + 1e-30) >= 100.0
        full = np.asarray(ref.full(x))
        got = y_fus[..., lat:]
        want = full[..., : got.shape[-1]]
        assert oracle.snr_db(want.astype(np.float64) + 1e-30,
                             got.astype(np.float64) + 1e-30) >= 100.0


class TestFIRGateStage:
    """The FIR+gate composite stage equals the composed FIRStage ->
    GateStage stream, and its stream == its full."""

    @pytest.mark.parametrize("release,taps", ((0.0, 64), (0.8, 64),
                                              (0.0, 768)))
    def test_matches_composed(self, rng, release, taps):
        from audiosignalprocess_tpu.pipeline import FIRGateStage

        h = oracle.design_fir(taps, 0.3 if taps == 64 else 0.2)
        x = (0.01 * rng.standard_normal((3, 8192))).astype(np.float32)
        x[:, 2048:6000] += np.sin(
            2 * np.pi * 440 * np.arange(3952) / 48000).astype(np.float32)
        comp = Chain([FIRStage(h=h, nfft=2048 if taps > 960 else 1024),
                      GateStage(nfft=1024, hop=256, noise_frames=4,
                                release=release)])
        one = Chain([FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4,
                                  release=release)])
        comp.build(); lat = one.build()
        y_c = np.asarray(comp.stream(x, 1024))
        y_o = np.asarray(one.stream(x, 1024))
        assert oracle.snr_db(y_c.astype(np.float64) + 1e-30,
                             y_o.astype(np.float64) + 1e-30) >= 100.0
        full = np.asarray(one.full(x))
        got = y_o[:, lat:]
        assert oracle.snr_db(
            full[:, : got.shape[-1]].astype(np.float64) + 1e-30,
            got.astype(np.float64) + 1e-30) >= 100.0

    def test_f64_falls_back_to_composition(self, rng):
        from audiosignalprocess_tpu.pipeline import FIRGateStage

        h = oracle.design_fir(64, 0.3)
        x = rng.standard_normal((2, 8192))  # f64
        one = Chain([FIRGateStage(h=h, nfft=1024, hop=256, noise_frames=4)])
        comp = Chain([FIRStage(h=h, nfft=1024),
                      GateStage(nfft=1024, hop=256, noise_frames=4)])
        one.build(); comp.build()
        np.testing.assert_allclose(np.asarray(one.stream(x, 1024)),
                                   np.asarray(comp.stream(x, 1024)),
                                   rtol=1e-9, atol=1e-12)


class TestSingleTap:
    def test_single_tap_fir_stage(self, rng):
        """len(h)==1 is stateless and must stream correctly."""
        x = rng.standard_normal((2, 1024))
        chain = Chain([FIRStage(h=np.array([0.5]))])
        lat = chain.build()
        full = np.asarray(chain.full(x))
        np.testing.assert_allclose(full, 0.5 * x, rtol=1e-12)
        streamed = np.asarray(chain.stream(x, 256))
        np.testing.assert_allclose(streamed, full, rtol=1e-12)


class TestNumericContract:
    """Pins the streaming numeric contract stated in pipeline.py's module
    docstring: structure exact, numerics f32 ~>=110 dB / f64 ~1e-12
    relative (reassociated identical arithmetic, not bit-for-bit)."""

    def test_stream_f32_snr_bound(self, rng):
        x = rng.standard_normal((2, 2048 * 6)).astype(np.float32)
        h = oracle.design_fir(64, 0.3)
        chain = Chain([
            FIRStage(h=h, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        lat = chain.build()
        full = np.asarray(chain.full(x))
        streamed = np.asarray(chain.stream(x, 2048))
        got = streamed[..., lat:]
        want = full[..., : got.shape[-1]]
        assert oracle.snr_db(want.astype(np.float64) + 1e-30,
                             got.astype(np.float64) + 1e-30) >= 110.0


class TestGateRelease:
    def test_gate_stage_release_stream_equals_full(self, rng):
        """Release smoothing threads through the streaming carry exactly."""
        x = rng.standard_normal((2, 2048 * 5))
        x[:, :4096] *= 0.01  # quiet head so the gate actually gates
        chain = Chain([GateStage(nfft=1024, hop=256, noise_frames=4,
                                 release=0.6)])
        _stream_equals_full(chain, x, 2048, rtol=1e-8, atol=1e-8)

    def test_release_changes_output(self, rng):
        """release > 0 is not a no-op (mask tails decay instead of cut)."""
        from audiosignalprocess_tpu.effects.noise_gate import noise_gate

        x = rng.standard_normal((1, 8192))
        x[:, 4096:] *= 0.001
        y0 = np.asarray(noise_gate(x, 1024, 256, noise_frames=4, release=0.0))
        y1 = np.asarray(noise_gate(x, 1024, 256, noise_frames=4, release=0.9))
        assert not np.allclose(y0, y1)


class TestStretchStage:
    """Streaming phase vocoder (SURVEY.md §2 row 14): stream == full at
    exact rational rates, interior-sample comparison (the whole-file tail
    ramp has no streaming counterpart — see StretchStage docstring)."""

    @staticmethod
    def _compare(chain, x, block, min_snr=180.0):
        lat = chain.build()
        full = np.asarray(chain.full(x))
        stream = np.asarray(chain.stream(x, block))
        got = stream[..., lat:]
        end = min(got.shape[-1], full.shape[-1]) - 2048  # skip tail region
        g, w = got[..., :end], full[..., :end]
        assert oracle.snr_db(w + 1e-30, g + 1e-30) >= min_snr

    @pytest.mark.parametrize("p,q", ((3, 4), (4, 3), (1, 2), (147, 160)))
    def test_stream_equals_full(self, rng, p, q):
        from audiosignalprocess_tpu.pipeline import StretchStage

        st = StretchStage(p=p, q=q, nfft=1024, hop=256)
        chain = Chain([st])
        m = p * max(1, 16 // p + 1)
        block = m * 256
        x = rng.standard_normal((2, block * 8))
        self._compare(chain, x, block)

    def test_from_rate_exact_and_irrational(self, rng):
        """from_rate: exact rationals pass through; irrational rates get
        the continued-fraction best approximation within the error bound,
        and the resulting stage streams == full like any rational stage."""
        from audiosignalprocess_tpu.pipeline import StretchStage

        st = StretchStage.from_rate(0.75, nfft=1024, hop=256)
        assert (st.p, st.q) == (3, 4)

        rate = 2.0 ** (1.0 / 3.0)  # irrational: 4-semitone tempo ratio
        st = StretchStage.from_rate(rate, max_den=64, nfft=256, hop=64)
        assert st.q <= 64 and abs(st.p / st.q - rate) < 1.0 / (st.q * 64)

        chain = Chain([st])
        m = st.p * max(1, 16 // st.p + 1)
        block = m * 64
        x = rng.standard_normal((2, block * 8))
        self._compare(chain, x, block)

        with pytest.raises(ValueError):
            StretchStage.from_rate(0.0)

    def test_after_gate(self, rng):
        """Stretch downstream of a latency-producing stage."""
        from audiosignalprocess_tpu.pipeline import StretchStage

        chain = Chain([
            GateStage(nfft=1024, hop=256, noise_frames=4),
            StretchStage(p=4, q=3, nfft=1024, hop=256),
        ])
        block = 4 * 16 * 256
        x = rng.standard_normal((2, block * 6))
        self._compare(chain, x, block)

    def test_pitch_shift_chain(self, rng):
        """Pitch shift = stretch 1/factor + resample (factor 2 = +1 octave):
        streaming == whole-file through the composed chain."""
        from audiosignalprocess_tpu.pipeline import StretchStage

        chain = Chain([
            StretchStage(p=1, q=2, nfft=1024, hop=256),
            ResampleStage(up=1, down=2),
        ])
        block = 2048
        x = rng.standard_normal((2, block * 8))
        self._compare(chain, x, block)

    @pytest.mark.parametrize("p,q", ((3, 4), (147, 160)))
    def test_fused_streaming_step(self, rng, p, q):
        """The stretch step with the matmul FFT tracks the default (XLA
        FFT) step and the whole-file path.  f32 bound is intrinsic: the
        rotor phase accumulator is chaotic under rounding (f32 stream ==
        full is itself ~80 dB), so the gate is 65 dB — above the 60 dB
        contract, far below the f64 exactness bound."""
        from audiosignalprocess_tpu.pipeline import StretchStage

        m = p * max(1, 16 // p + 1)
        block = m * 256
        x = rng.standard_normal((2, block * 8)).astype(np.float32)
        ref = Chain([StretchStage(p=p, q=q, nfft=1024, hop=256)])
        fus = Chain([StretchStage(p=p, q=q, nfft=1024, hop=256,
                                  impl="matmul")])
        lat = ref.build(); fus.build()
        y_ref = np.asarray(ref.stream(x, block))
        y_fus = np.asarray(fus.stream(x, block))
        assert oracle.snr_db(y_ref.astype(np.float64) + 1e-30,
                             y_fus.astype(np.float64) + 1e-30) >= 65.0
        full = np.asarray(ref.full(x))
        got = y_fus[..., lat:]
        end = min(got.shape[-1], full.shape[-1]) - 2048
        assert oracle.snr_db(full[..., :end].astype(np.float64) + 1e-30,
                             got[..., :end].astype(np.float64) + 1e-30) >= 65.0

    def test_full_matches_time_stretch(self, rng):
        """StretchStage.full == effects.time_stretch at the same rational
        rate (integer-exact frame grid)."""
        from audiosignalprocess_tpu.effects.phase_vocoder import time_stretch
        from audiosignalprocess_tpu.pipeline import StretchStage

        x = rng.standard_normal((2, 16384))
        st = StretchStage(p=3, q=4, nfft=1024, hop=256)
        st.configure(0)
        y = np.asarray(st.full(x))
        ref = np.asarray(time_stretch(x, 0.75))
        n = min(y.shape[-1], ref.shape[-1])
        np.testing.assert_allclose(y[..., :n], ref[..., :n], rtol=1e-7, atol=1e-8)


class TestDrain:
    """End-of-file flush (VERDICT r2 item 3, BASELINE.json:5 "bit-for-bit
    in structure" includes the file tail): ``stream(x, block, drain=True)``
    and ``full_flush(x)`` emit EXACTLY ``out_len(len(x))`` samples aligned
    to position 0 for ARBITRARY (non-block-multiple) input lengths, and
    agree to streaming reassociation."""

    @staticmethod
    def _drain_equals_flush(chain, x, block, min_snr=100.0):
        import jax

        chain.build()
        n = x.shape[-1]
        want = chain.out_len(n)
        ff = np.asarray(jax.jit(chain.full_flush)(x))
        st = np.asarray(jax.jit(lambda v: chain.stream(v, block, drain=True))(x))
        assert ff.shape[-1] == want and st.shape == ff.shape
        assert oracle.snr_db(ff.astype(np.float64) + 1e-30,
                             st.astype(np.float64) + 1e-30) >= min_snr

    def test_fir_non_multiple_length(self, rng):
        h = oracle.design_fir(64, 0.25)
        x = rng.standard_normal((2, 4097))
        self._drain_equals_flush(Chain([FIRStage(h=h, nfft=1024)]), x, 512)

    def test_fir_causal_flush_is_exact_full(self, rng):
        """For a pure causal sample-map chain, full_flush == full exactly
        (zero tail_width contribution beyond the FIR history)."""
        h = oracle.design_fir(64, 0.25)
        c = Chain([FIRStage(h=h)])
        c.build()
        x = rng.standard_normal(4097)
        np.testing.assert_allclose(
            np.asarray(c.full_flush(x)), np.asarray(c.full(x)),
            rtol=1e-12, atol=1e-12)

    def test_gate_drain(self, rng):
        n = 8192 + 100
        x = 0.01 * rng.standard_normal((1, n))
        x[:, 3000:6000] += np.sin(2 * np.pi * 440.0 * np.arange(3000) / 48000.0)
        self._drain_equals_flush(Chain([GateStage(nfft=1024, hop=256)]), x, 2048)

    def test_gate_fused_block_equals_hop(self, rng):
        """The smallest legal streaming block (block == hop, one frame
        per step) streams == full."""
        for nfft, hop in ((1024, 256), (512, 128)):
            chain = Chain([GateStage(nfft=nfft, hop=hop, noise_frames=4)])
            chain.build()
            x = (0.01 * rng.standard_normal((2, 4096))).astype(np.float32)
            x[:, 1000:3000] += np.sin(
                2 * np.pi * 440.0 * np.arange(2000) / 48000).astype(np.float32)
            import jax.numpy as jnp

            st = chain.init_state((2,), hop, jnp.float32)
            assert isinstance(st[0], dict) and st[0]["fifo_r"].shape == (
                2, 4, nfft // 2 + 1)
            y = np.asarray(chain.stream(x, hop))
            full = np.asarray(chain.full(x))
            lat = chain.latency
            assert oracle.snr_db(
                full[..., : y.shape[-1] - lat].astype(np.float64) + 1e-30,
                y[..., lat:].astype(np.float64) + 1e-30) >= 100.0

    def test_composite_block_quantum_error_names_input_block(self, rng):
        """A misaligned composite block must be reported in the INPUT
        domain (the user's block), not the resampled one."""
        from audiosignalprocess_tpu.pipeline import ResFIRGateStage

        c = Chain([ResFIRGateStage(up=160, down=147,
                                   h=oracle.design_fir(64, 0.3))])
        c.build()
        x = rng.standard_normal((1, 4410 * 8)).astype(np.float32)
        with pytest.raises(ValueError, match="input quantum 1176"):
            c.stream(x, 4410)

    def test_gate_drain_short_input_raises_like_full_flush(self, rng):
        """Drain must enforce the SAME noise-floor completeness bound as
        full_flush: an input with fewer than noise_frames complete frames
        raises instead of silently gating against a partial floor
        (round-3 review regression — stream(drain=True) emitted output
        where full_flush raised)."""
        chain = Chain([GateStage(nfft=1024, hop=256, noise_frames=8)])
        chain.build()
        x = 0.01 * rng.standard_normal((1, 2100))  # 5 frames < 8
        with pytest.raises(ValueError, match="noise_frames"):
            chain.full_flush(x)
        with pytest.raises(ValueError, match="noise_frames"):
            chain.stream(x, 512, drain=True)

    def test_resample_drain_length_is_rate_map(self, rng):
        """out_len is the ceil rate map: 147 in -> 160 out at 160/147."""
        c = Chain([ResampleStage(up=160, down=147)])
        c.build()
        assert c.out_len(147) == 160 and c.out_len(148) == 162  # ceil(148*160/147)
        x = rng.standard_normal((2, 14700 + 123))
        self._drain_equals_flush(c, x, 1470)

    def test_config5_chain_drain(self, rng):
        h = oracle.design_fir(64, 0.3)
        c = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=h, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        # own seed: the input must not depend on how many draws earlier
        # tests took from the shared rng — a bin sitting on the gate's
        # hard threshold flips between stream and full in f32 (ROADMAP,
        # "hard-threshold gate"), and such draws exist
        x = np.random.default_rng(0).standard_normal(
            (2, 14700 * 2 + 777)).astype(np.float32)
        self._drain_equals_flush(c, x, 2352, min_snr=90.0)

    @pytest.mark.parametrize("p,q", ((4, 3), (3, 4)))
    def test_stretch_drain(self, rng, p, q):
        from audiosignalprocess_tpu.pipeline import StretchStage

        c = Chain([StretchStage(p=p, q=q, nfft=1024, hop=256)])
        x = rng.standard_normal((1, 12288 + 321)).astype(np.float32)
        self._drain_equals_flush(c, x, 256 * p, min_snr=90.0)

    def test_drain_block_multiple_matches_plain_stream(self, rng):
        """When n IS a block multiple, drain's emission prefix equals the
        plain stream's latency-stripped emission on the same input."""
        h = oracle.design_fir(64, 0.25)
        c = Chain([FIRStage(h=h)])
        lat = c.build()
        x = rng.standard_normal(4096)
        plain = np.asarray(c.stream(x, 512))[..., lat:]
        drained = np.asarray(c.stream(x, 512, drain=True))
        np.testing.assert_allclose(
            drained[..., : plain.shape[-1]], plain, rtol=1e-12, atol=1e-12)

    # -- f32 drains, through the matmul FFT where a default-FFT case exists

    def test_gate_drain_fused(self, rng):
        n = 8192 + 100
        x = 0.01 * rng.standard_normal((1, n)).astype(np.float32)
        x[:, 3000:6000] += np.sin(
            2 * np.pi * 440.0 * np.arange(3000) / 48000.0).astype(np.float32)
        self._drain_equals_flush(
            Chain([GateStage(nfft=1024, hop=256, impl="matmul")]), x, 2048,
            min_snr=90.0)

    def test_stretch_drain_fused(self, rng):
        from audiosignalprocess_tpu.pipeline import StretchStage

        c = Chain([StretchStage(p=4, q=3, nfft=1024, hop=256,
                                impl="matmul")])
        x = rng.standard_normal((1, 12288 + 321)).astype(np.float32)
        self._drain_equals_flush(c, x, 256 * 4, min_snr=90.0)

    @pytest.mark.parametrize("env", (False, True))
    def test_res_fir_gate_drain_fused(self, rng, env):
        """The flagship composite (config 5, envelope appended when
        env=True) drains to full() parity: the envelope consumes the
        gate's tail-renormalized samples."""
        from audiosignalprocess_tpu.pipeline import ResFIRGateStage

        h = oracle.design_fir(64, 0.3)
        env_h = oracle.design_fir(129, 2.0 * 50.0 / 48000) if env else None
        c = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024,
                                   hop=256, noise_frames=4, env_h=env_h)])
        c.build()
        st = c.init_state((1,), 2 * 1176, np.float32)
        assert len(st[0][1]) == (3 if env else 2)  # FIR, gate(, envelope)
        x = 0.01 * rng.standard_normal((1, 14700 * 2 + 777)).astype(np.float32)
        x[:, 8000:20000] += np.sin(
            2 * np.pi * 440.0 * np.arange(12000) / 44100.0).astype(np.float32)
        self._drain_equals_flush(c, x, 2 * 1176, min_snr=80.0)

    # -- geometry fuzz ------------------------------------------------------

    @staticmethod
    def _fuzz_cases(k):
        rng = np.random.default_rng(2028)
        out = []
        # streaming needs COLA for w^2 (interior const norm): overlap >= 4x
        combos = [(512, 128), (1024, 256), (1024, 128), (2048, 512)]
        for _ in range(k):
            nfft, hop = combos[int(rng.integers(len(combos)))]
            # block: a hop multiple; n: anything past the set_eof guards
            block = hop * int(rng.integers(2, 9))
            n = int(rng.integers(3 * nfft, 10 * nfft)) \
                + int(rng.integers(hop))
            impl = ("xla", "matmul")[int(rng.integers(2))]
            out.append((nfft, hop, block, n, impl))
        return out

    @pytest.mark.parametrize("nfft,hop,block,n,impl", _fuzz_cases.__func__(10))
    def test_gate_drain_fuzz(self, rng, nfft, hop, block, n, impl):
        """Drain == full_flush across random (nfft, hop, block, n, impl)
        geometries — the EOF machinery's branch points (pad, drain
        blocks, frame bounds, tail-ramp offsets) all move with these."""
        x = (0.01 * rng.standard_normal((2, n))).astype(np.float32)
        x[:, n // 4 : n // 2] += np.sin(
            0.05 * np.arange(n // 2 - n // 4)).astype(np.float32)
        c = Chain([GateStage(nfft=nfft, hop=hop, noise_frames=4,
                             impl=impl)])
        self._drain_equals_flush(c, x, block, min_snr=90.0)
