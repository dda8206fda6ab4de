"""Sharding tests on 8 virtual CPU devices (SURVEY.md §4.3): every
shard_map path asserts sharded == unsharded output exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import fir_direct
from audiosignalprocess_tpu.ops.resample import resample_poly
from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
from audiosignalprocess_tpu.parallel.sharded import (
    sharded_chain, sharded_fir, sharded_noise_gate, sharded_overlap_save,
    sharded_resample,
)
from audiosignalprocess_tpu.pipeline import Chain, FIRStage, GateStage, ResampleStage


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(17)


@pytest.fixture(autouse=True)
def _eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")

MESHES = ((1, 8), (8, 1), (2, 4), (4, 2))


class TestShardedFIR:
    @pytest.mark.parametrize("ch,tm", MESHES)
    def test_fir_matches_unsharded(self, rng, ch, tm):
        mesh = make_mesh(channel=ch, time=tm)
        h = oracle.design_fir(64, 0.25)
        x = rng.standard_normal((8, 4096))
        fn = sharded_fir(mesh, h)
        out = np.asarray(fn(shard_audio(x, mesh)))
        ref = np.asarray(fir_direct(x, h))
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("ch,tm", ((2, 4), (1, 8)))
    def test_overlap_save_4096taps(self, rng, ch, tm):
        """Config 4 structure: long FIR with halo exchange (BASELINE.json:10)."""
        mesh = make_mesh(channel=ch, time=tm)
        h = oracle.design_fir(4096, 0.1)
        x = rng.standard_normal((8, 8 * 8192))
        fn = sharded_overlap_save(mesh, h, nfft=16384)
        out = np.asarray(fn(shard_audio(x, mesh)))
        ref = np.stack([oracle.fir_direct(x[i], h) for i in range(8)])
        np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


class TestShardedResample:
    @pytest.mark.parametrize("up,down", ((160, 147), (2, 1), (3, 4)))
    def test_matches_unsharded(self, rng, up, down):
        mesh = make_mesh(channel=2, time=4)
        n = down * 128 * 4  # divisible by down per shard
        x = rng.standard_normal((8, n))
        fn = sharded_resample(mesh, up, down)
        out = np.asarray(fn(shard_audio(x, mesh)))
        ref = np.asarray(resample_poly(x, up, down, zero_phase=False))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)


class TestShardedGate:
    def _mk(self, rng, c, n):
        fs = 48000
        t = np.arange(n) / fs
        x = 0.01 * rng.standard_normal((c, n))
        x += np.where((t > 0.2) & (t < 0.5), np.sin(2 * np.pi * 440.0 * t), 0.0)
        return x

    @pytest.mark.parametrize("ch,tm", ((8, 1), (2, 4), (1, 8)))
    def test_matches_full(self, rng, ch, tm):
        """Config 3: channel-sharded STFT noise gate (BASELINE.json:9)."""
        mesh = make_mesh(channel=ch, time=tm)
        n = 8192 * 8
        x = self._mk(rng, 8, n)
        g = GateStage()
        chain = Chain([g])
        chain.build()
        ref = np.asarray(chain.full(jnp.asarray(x)))
        fn = sharded_noise_gate(mesh)
        out = np.asarray(fn(shard_audio(x, mesh)))
        np.testing.assert_allclose(out, ref, rtol=1e-7, atol=1e-9)


class TestShardedChain:
    def test_chain_matches_full(self, rng):
        """Config 5 spatial form: resample -> FIR -> gate, (2,4) mesh."""
        mesh = make_mesh(channel=2, time=4)
        n = 147 * 512  # per-shard n/4 divisible by 147; after resample by hop
        x = rng.standard_normal((8, n))
        chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        chain.build()
        ref = np.asarray(chain.full(jnp.asarray(x)))
        fn = sharded_chain(mesh, chain)
        out = np.asarray(fn(shard_audio(x, mesh)))
        np.testing.assert_allclose(out, ref, rtol=1e-7, atol=1e-9)

    def test_composite_stage_matches_components(self, rng):
        """FIRGateStage/ResFIRGateStage shard as their exact component
        composition (same halo/psum structure as the plain chain)."""
        from audiosignalprocess_tpu.pipeline import ResFIRGateStage

        mesh = make_mesh(channel=2, time=4)
        n = 147 * 512
        x = rng.standard_normal((8, n))
        h = oracle.design_fir(64, 0.3)
        comp = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024,
                                      hop=256, noise_frames=4)])
        comp.build()
        ref_chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=h, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
        ])
        ref_chain.build()
        ref = np.asarray(ref_chain.full(jnp.asarray(x)))
        out = np.asarray(sharded_chain(mesh, comp)(shard_audio(x, mesh)))
        np.testing.assert_allclose(out, ref, rtol=1e-7, atol=1e-9)

    def test_composite_sharded_fused_f32(self, rng):
        """f32 sharded composite matches the whole-file composite to the
        streaming-reassociation bound."""
        from audiosignalprocess_tpu.pipeline import ResFIRGateStage

        mesh = make_mesh(channel=2, time=4)
        n = 147 * 512
        x = (0.01 * rng.standard_normal((8, n))).astype(np.float32)
        x[:, n // 4: n // 2] += np.sin(
            2 * np.pi * 440 * np.arange(n // 2 - n // 4) / 44100
        ).astype(np.float32)
        h = oracle.design_fir(64, 0.3)
        comp = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024,
                                      hop=256, noise_frames=4)])
        comp.build()
        ref = np.asarray(jax.jit(comp.full)(jnp.asarray(x)))
        out = np.asarray(sharded_chain(mesh, comp)(shard_audio(x, mesh)))
        m = min(ref.shape[-1], out.shape[-1])
        assert oracle.snr_db(ref[..., :m].astype(np.float64) + 1e-30,
                             out[..., :m].astype(np.float64) + 1e-30) >= 80.0

    def test_composite_env_stage_matches_components(self, rng):
        """An appended envelope tail shards as the direct-FIR form (|x|
        halo + FIR): the full config-5 composite == its four components."""
        from audiosignalprocess_tpu.pipeline import (
            EnvelopeStage, ResFIRGateStage,
        )

        mesh = make_mesh(channel=2, time=4)
        n = 147 * 512
        x = rng.standard_normal((8, n))
        h = oracle.design_fir(64, 0.3)
        he = oracle.design_fir(129, 0.05)
        comp = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024,
                                      hop=256, noise_frames=4, env_h=he)])
        comp.build()
        ref_chain = Chain([
            ResampleStage(up=160, down=147),
            FIRStage(h=h, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
            EnvelopeStage(he),
        ])
        ref_chain.build()
        ref = np.asarray(ref_chain.full(jnp.asarray(x)))
        out = np.asarray(sharded_chain(mesh, comp)(shard_audio(x, mesh)))
        np.testing.assert_allclose(out, ref, rtol=1e-7, atol=1e-9)


class TestHaloPrimitives:
    def test_halo_left_right(self, rng):
        from functools import partial
        from jax.sharding import PartitionSpec as P
        from audiosignalprocess_tpu.parallel.halo import halo_left, halo_right

        mesh = make_mesh(channel=1, time=8)
        x = np.arange(64, dtype=np.float32).reshape(1, 64)

        fn = jax.jit(
            jax.shard_map(
                lambda v: halo_left(v, 2, "time"),
                mesh=mesh, in_specs=(P("channel", "time"),),
                out_specs=P("channel", "time"),
            )
        )
        out = np.asarray(fn(shard_audio(x, mesh)))  # (1, 8*(2+8))
        shards = out.reshape(8, 10)
        np.testing.assert_array_equal(shards[0, :2], [0, 0])
        for s in range(1, 8):
            np.testing.assert_array_equal(shards[s, :2], x[0, s * 8 - 2 : s * 8])
            np.testing.assert_array_equal(shards[s, 2:], x[0, s * 8 : (s + 1) * 8])

        fn_r = jax.jit(
            jax.shard_map(
                lambda v: halo_right(v, 3, "time"),
                mesh=mesh, in_specs=(P("channel", "time"),),
                out_specs=P("channel", "time"),
            )
        )
        out_r = np.asarray(fn_r(shard_audio(x, mesh))).reshape(8, 11)
        np.testing.assert_array_equal(out_r[7, 8:], [0, 0, 0])
        for s in range(7):
            np.testing.assert_array_equal(out_r[s, 8:], x[0, (s + 1) * 8 : (s + 1) * 8 + 3])


class TestGuards:
    """Regression tests for silently-wrong sharded configurations (now
    hard errors): halo > shard length, noise floor spanning shards."""

    def test_halo_exceeds_shard_raises(self, rng):
        mesh = make_mesh(channel=1, time=8)
        h = oracle.design_fir(512, 0.1)
        x = rng.standard_normal((1, 8 * 256))  # 256/shard < 511 halo
        with pytest.raises(ValueError, match="halo"):
            sharded_fir(mesh, h)(shard_audio(x, mesh))

    def test_noise_frames_exceed_shard_raises(self, rng):
        mesh = make_mesh(channel=1, time=8)
        x = rng.standard_normal((1, 8 * 1024))  # 4 frames/shard < 8
        with pytest.raises(ValueError, match="noise_frames"):
            sharded_noise_gate(mesh)(shard_audio(x, mesh))


class TestHaloEdgeCases:
    def test_zero_halo_is_identity(self, rng):
        """halo == 0 must return the shard unchanged: x[..., -0:] would
        slice (and ppermute) the WHOLE shard, doubling the output."""
        from audiosignalprocess_tpu.parallel.halo import halo_left, halo_right

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        mesh = make_mesh(channel=1, time=8)
        x = rng.standard_normal((2, 8 * 64)).astype(np.float32)
        for fn in (halo_left, halo_right):
            body = shard_map(lambda v: fn(v, 0), mesh=mesh,
                             in_specs=P(None, "time"),
                             out_specs=P(None, "time"))
            np.testing.assert_array_equal(np.asarray(body(jnp.asarray(x))), x)


class TestFusedSharded:
    """f32 sharded bodies vs the whole-file f32 op and the f64 oracle."""

    def test_overlap_save_fused_per_shard(self, rng):
        """f32 overlap-save inside shard_map (halo feeds its history)."""
        mesh = make_mesh(channel=2, time=4)
        h = oracle.design_fir(64, 0.25)
        x = rng.standard_normal((8, 8192)).astype(np.float32)
        out = np.asarray(sharded_overlap_save(mesh, h, 1024)(
            shard_audio(x, mesh)))
        ref = np.stack([oracle.fir_direct(x[i].astype(np.float64), h)
                        for i in range(8)])
        assert oracle.snr_db(ref, out.astype(np.float64)) >= 60.0

    @pytest.mark.parametrize("ch,tm", ((1, 8), (2, 4), (4, 2), (8, 1)))
    def test_gate_fused_time_sharded(self, rng, ch, tm):
        """f32 gate per time shard with the cross-shard constructs —
        psum'd noise floor, EOF frame validity, OLA spill exchange,
        global-position WOLA norm.  Matches the one-device run bitwise on
        channel-only meshes, the whole-file f32 gate (OLA re-association
        at shard boundaries) and the f64 oracle."""
        from audiosignalprocess_tpu.effects.noise_gate import noise_gate

        mesh = make_mesh(channel=ch, time=tm)
        n = 8192 * 4
        fs = 48000
        t = np.arange(n) / fs
        x = (0.01 * rng.standard_normal((8, n))).astype(np.float32)
        x += np.where((t > 0.2) & (t < 0.5),
                      np.sin(2 * np.pi * 440.0 * t), 0.0).astype(np.float32)
        out = np.asarray(sharded_noise_gate(mesh, noise_frames=8)(
            shard_audio(x, mesh)))
        ref = np.asarray(jax.jit(lambda v: noise_gate(
            v, 1024, 256, 6.0, 60.0, 8, 0.0, "hann"))(jnp.asarray(x)))
        ref = np.concatenate(
            [ref, np.zeros((8, n - ref.shape[-1]), np.float32)], axis=-1)
        if tm == 1:
            # channel sharding alone changes no bit of the one-device run
            one = make_mesh(channel=1, time=1)
            np.testing.assert_array_equal(
                out, np.asarray(sharded_noise_gate(one, noise_frames=8)(
                    shard_audio(x, one))))
        assert oracle.snr_db(ref.astype(np.float64) + 1e-30,
                             out.astype(np.float64) + 1e-30) >= 120.0
        ref_o = oracle.noise_gate(x.astype(np.float64), 1024, 256,
                                  noise_frames=8)
        m = min(ref_o.shape[-1], n)
        assert oracle.snr_db(ref_o[..., :m],
                             out[..., :m].astype(np.float64)) >= 60.0


    def test_gate_fused_short_shards(self, rng):
        """Shards SHORTER than the noise-floor span (l < nfft +
        (noise_frames-1)*hop) still gate == the whole-file f32 gate: the
        floor frames of shard 0 come from its halo-extended signal."""
        from audiosignalprocess_tpu.effects.noise_gate import noise_gate

        mesh = make_mesh(channel=1, time=8)
        n = 16384  # l = 2048 < 1024 + 7*256 = 2816 prologue samples
        x = (0.01 * rng.standard_normal((8, n))).astype(np.float32)
        x[:, 4000:9000] += np.sin(
            2 * np.pi * 440.0 * np.arange(5000) / 48000).astype(np.float32)
        out = np.asarray(sharded_noise_gate(mesh, noise_frames=8)(
            shard_audio(x, mesh)))
        ref = np.asarray(jax.jit(lambda v: noise_gate(
            v, 1024, 256, noise_frames=8))(jnp.asarray(x)))
        ref = np.concatenate(
            [ref, np.zeros((8, n - ref.shape[-1]), np.float32)], axis=-1)
        assert oracle.snr_db(ref.astype(np.float64) + 1e-30,
                             out.astype(np.float64) + 1e-30) >= 120.0


class TestShardedGateRelease:
    @pytest.mark.parametrize("ch,tm", ((1, 8), (2, 4)))
    def test_release_matches_unsharded(self, rng, ch, tm):
        """Cross-shard release continuity (all_gather of per-shard scan
        summaries) == the whole-file release scan."""
        from audiosignalprocess_tpu.effects.noise_gate import noise_gate

        mesh = make_mesh(channel=ch, time=tm)
        x = rng.standard_normal((8, 8 * 4096))
        x[:, : 3 * 4096] *= 0.01
        fn = sharded_noise_gate(mesh, nfft=1024, hop=256, noise_frames=8,
                                release=0.8)
        out = np.asarray(fn(shard_audio(x, mesh)))
        ref = np.asarray(noise_gate(x, 1024, 256, noise_frames=8, release=0.8))
        np.testing.assert_allclose(out[..., : ref.shape[-1]], ref,
                                   rtol=1e-8, atol=1e-8)


class TestShardedStretch:
    """Sharded phase vocoder == StretchStage.full (SURVEY.md §2 row 14:
    cross-shard phase continuity via gathered per-shard dphi prefix)."""

    @pytest.mark.parametrize("p,q,ch,tm", ((3, 4, 2, 4), (4, 3, 1, 8),
                                           (147, 160, 2, 4)))
    def test_matches_full(self, rng, p, q, ch, tm):
        from audiosignalprocess_tpu.parallel.sharded import sharded_time_stretch
        from audiosignalprocess_tpu.pipeline import StretchStage

        st = StretchStage(p=p, q=q, nfft=1024, hop=256)
        st.configure(0)
        m = p * max(1, 8 // p + 1) * 4
        l = m * 256
        x = rng.standard_normal((4, tm * l))
        mesh = make_mesh(channel=ch, time=tm)
        out = np.asarray(sharded_time_stretch(mesh, p, q, 1024, 256)(
            shard_audio(x, mesh)))
        ref = np.asarray(st.full(jnp.asarray(x)))
        assert out.shape == ref.shape
        assert oracle.snr_db(ref + 1e-30, out + 1e-30) >= 180.0

    def test_chain_with_stretch(self, rng):
        """sharded_chain routes StretchStage through stretch_shard_body."""
        from audiosignalprocess_tpu.pipeline import StretchStage

        h = oracle.design_fir(64, 0.25)
        chain = Chain([FIRStage(h=h), StretchStage(p=4, q=3, nfft=1024,
                                                   hop=256)])
        chain.build()
        mesh = make_mesh(channel=2, time=4)
        l = 4 * 16 * 256
        x = rng.standard_normal((4, 4 * l))
        fn = sharded_chain(mesh, chain)
        out = np.asarray(fn(shard_audio(x, mesh)))
        ref = np.asarray(chain.full(jnp.asarray(x)))
        assert out.shape == ref.shape
        assert oracle.snr_db(ref + 1e-30, out + 1e-30) >= 180.0


class TestShardedStreaming:
    """Channel-sharded streaming: Chain.stream jitted with the batch axis
    sharded over the channel mesh axis (DP streaming — embarrassingly
    parallel, no collectives) equals the unsharded stream."""

    def test_stream_channel_sharded(self, rng):
        from jax.sharding import NamedSharding, PartitionSpec as P
        from audiosignalprocess_tpu.pipeline import StretchStage

        mesh = make_mesh(channel=8, time=1)
        h = oracle.design_fir(64, 0.3)
        chain = Chain([
            FIRStage(h=h, nfft=1024),
            GateStage(nfft=1024, hop=256, noise_frames=4),
            StretchStage(p=4, q=3, nfft=1024, hop=256),
        ])
        chain.build()
        block = 4 * 16 * 256
        x = rng.standard_normal((8, block * 4)).astype(np.float32)
        fn = jax.jit(
            lambda v: chain.stream(v, block),
            in_shardings=NamedSharding(mesh, P("channel", None)),
        )
        out = np.asarray(fn(jnp.asarray(x)))
        ref = np.asarray(chain.stream(jnp.asarray(x), block))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
