"""Sharded whole-file operators: shard_map programs over a (channel, time)
mesh whose outputs equal the unsharded ops EXACTLY (SURVEY.md §4.3).

Design (SURVEY.md §3.3, §5):
- causal filters (FIR / overlap-save / resampler / envelope): left halo of
  the filter history via ppermute — the streaming carry, spatialized.
- STFT effects: right halo of nfft-hop samples for frame assembly, then an
  overlap-add boundary fix-up sending each shard's OLA spill to its right
  neighbor; the noise floor (a global statistic of the first frames) is
  broadcast from time-shard 0 with a psum.

All comms are single-hop neighbor ppermutes + one psum; across GPUs XLA
hands them to NCCL (over NVLink within a host), and its async collectives
can overlap them with the per-shard FFT work.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.effects.noise_gate import gate_mask
from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.fir import fir_direct
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.ops.resample import history_len, resample_poly
from audiosignalprocess_tpu.ops.stft import frame as frame_op
from audiosignalprocess_tpu.ops.windows import window_np
from audiosignalprocess_tpu.parallel.halo import halo_left, halo_right, send_right_add
from audiosignalprocess_tpu.utils.validate import check

_SPEC = P("channel", "time")


def _check_halo(halo: int, local_len: int) -> None:
    """Halo exchange is single-hop: the required history must fit in ONE
    neighbor shard, else jnp slice-clamping silently fabricates history."""
    check(halo <= local_len, f"halo {halo} exceeds local shard length {local_len}: use fewer "
        f"time shards or a shorter filter (single-hop halo exchange)")


def _smap(mesh: Mesh, fn):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC))


# ---------------------------------------------------------------------------
# Causal filters: left halo == spatialized streaming carry
# ---------------------------------------------------------------------------


def sharded_fir(mesh: Mesh, h) -> callable:
    """(C, N) -> (C, N) causal FIR == ops.fir.fir_direct, (channel, time) sharded."""
    h = np.asarray(h, np.float64)
    t = len(h)

    def local(x):
        _check_halo(t - 1, x.shape[-1])
        ext = halo_left(x, t - 1, "time")
        return fir_direct(x, h, history=ext[..., : t - 1])

    return _smap(mesh, local)


def sharded_overlap_save(mesh: Mesh, h, nfft: int,
                         impl: str = fft_ops.DEFAULT_IMPL) -> callable:
    """(C, N) -> (C, N) causal FIR via overlap-save with halo exchange
    (config 4, BASELINE.json:10)."""
    h = np.asarray(h, np.float64)
    t = len(h)

    def local(x):
        _check_halo(t - 1, x.shape[-1])
        ext = halo_left(x, t - 1, "time")
        return overlap_save(x, h, nfft, history=ext[..., : t - 1], impl=impl)

    return _smap(mesh, local)


def sharded_resample(mesh: Mesh, up: int, down: int, h=None) -> callable:
    """(C, N) -> (C, N*up/down) causal polyphase resample, halo'd."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if h is None:
        h = oracle.resample_filter(up, down)
    h = np.asarray(h, np.float64)
    hl = history_len(len(h), up, down)

    def local(x):
        check(x.shape[-1] % down == 0,
              f"local shard length {x.shape[-1]} must be a multiple of "
              f"down={down} (integral resampled length per shard)")
        _check_halo(hl, x.shape[-1])
        ext = halo_left(x, hl, "time")
        return resample_poly(x, up, down, h=h, zero_phase=False,
                             history=ext[..., :hl])

    return _smap(mesh, local)


# ---------------------------------------------------------------------------
# Sharded spectral noise gate
# ---------------------------------------------------------------------------


def _gate_norms(nfft: int, hop: int, window_kind: str):
    """(head_ramp(d), tail_ramp(d), interior_const) of the whole-file WOLA
    norm, sliced from the exact per-sample norm (ops.stft._wola_norm) so
    the ramp math has a single source of truth."""
    from audiosignalprocess_tpu.ops.stft import _wola_norm

    d = nfft - hop
    r = nfft // hop
    norm = _wola_norm(2 * r, nfft, hop, window_kind)  # long enough: interior exists
    return norm[:d].copy(), norm[-d:].copy(), float(norm[d])


def gate_shard_body(
    x: jnp.ndarray,
    nfft: int,
    hop: int,
    threshold_db: float,
    reduction_db: float,
    noise_frames: int,
    window_kind: str,
    impl: str,
    axis_name: str = "time",
    release: float = 0.0,
) -> jnp.ndarray:
    """Per-shard gate body; call inside shard_map.  Output == GateStage.full
    restricted to this shard's region (last nfft-hop global samples zero)."""
    dtype = x.dtype
    d = nfft - hop
    l = x.shape[-1]
    check(l % hop == 0 and l >= nfft, "shard length must be >= nfft, hop-aligned")
    check(l // hop >= noise_frames, f"shard 0 holds {l // hop} frames < noise_frames={noise_frames}: "
        f"the noise floor lives on the first shard (use longer shards)")
    n_sh = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    n_glob = l * n_sh
    n_frames_glob = 1 + (n_glob - nfft) // hop
    check(n_frames_glob * hop >= 2 * d, "signal too short: WOLA head and tail ramps overlap")
    check(n_frames_glob >= noise_frames, f"signal has {n_frames_glob} frames < noise_frames={noise_frames}")
    head_np, tail_np, const = _gate_norms(nfft, hop, window_kind)
    w = jnp.asarray(window_np(window_kind, nfft), dtype)
    ext = halo_right(x, d, axis_name)
    m = l // hop
    starts = idx * l + hop * jnp.arange(m, dtype=jnp.int32)
    valid_f = starts <= n_glob - nfft
    frames = frame_op(ext, nfft, hop)  # (..., l/hop, nfft)
    valid = valid_f[:, None].astype(dtype)
    spec = fft_ops.rfft(frames * w, impl=impl) * valid
    mag = jnp.abs(spec).astype(dtype)
    # global noise floor: the first noise_frames frames live on shard 0
    floor_loc = jnp.mean(mag[..., :noise_frames, :], axis=-2, keepdims=True)
    floor_loc = jnp.where(idx == 0, floor_loc, jnp.zeros_like(floor_loc))
    floor = lax.psum(floor_loc, axis_name)
    # local release scan (gate_mask handles release == 0 as a no-op)
    mask = gate_mask(mag, floor, threshold_db, reduction_db, release)
    if release > 0.0 and n_sh > 1:
        # Cross-shard release continuity.  The frame axis is the time
        # shards in order; the scan s_q = max(mask_q, r*s_{q-1}) factors:
        # with L_j = shard j's final LOCALLY-scanned state, the incoming
        # carry obeys C_i = max(L_{i-1}, r^m * C_{i-1}), i.e.
        # C_i = max_{j<i} L_j * r^{m*(i-1-j)}; then the corrected local
        # scan is s'_q = max(s_q, C_i * r^{q+1}).  One all_gather of the
        # (nbins,)-sized summaries — the gather is tiny.
        L = mask[..., -1:, :]
        allL = lax.all_gather(L, axis_name)  # (n_sh, ..., 1, nbins)
        rm = release ** m
        C = jnp.zeros_like(L)
        for j in range(n_sh - 1):
            e = jnp.maximum(idx - 1 - j, 0).astype(dtype)
            decay = jnp.power(jnp.asarray(rm, dtype), e)
            C = jnp.maximum(C, jnp.where(j < idx, allL[j] * decay, 0.0))
        rel_pows = jnp.asarray(
            release ** (np.arange(1, m + 1, dtype=np.float64)), dtype
        )[:, None]
        mask = jnp.maximum(mask, rel_pows * C)
    out_frames = fft_ops.irfft(spec * mask, nfft, impl=impl) * w
    # OLA of m frames -> l + d samples; spill the tail to the right neighbor
    r = nfft // hop
    fr = out_frames.reshape(out_frames.shape[:-1] + (r, hop))
    rows = m + r - 1
    acc = jnp.zeros(x.shape[:-1] + (rows, hop), dtype)
    for j in range(r):
        acc = acc.at[..., j : j + m, :].add(fr[..., :, j, :])
    acc = acc.reshape(x.shape[:-1] + (rows * hop,))[..., : l + d]
    return _spill_and_norm(acc, idx, l, d,
                           nfft + ((n_glob - nfft) // hop) * hop,
                           head_np, tail_np, const, dtype, axis_name)


def _spill_and_norm(acc, idx, l_out, d, out_len, head_np, tail_np, const,
                    dtype, axis_name):
    """Shared sharded WOLA epilogue (gate and vocoder): exchange the
    d-sample OLA spill into the right neighbor's head (SURVEY.md §2 P4),
    then divide by the whole-file WOLA norm at global positions (head
    ramp / interior / finite-file tail ramp / 1.0 in the zero pad).

    ``acc`` holds ``l_out + d`` locally-accumulated samples; ``out_len``
    is the GLOBAL synthesis length (nfft + (F-1)*hop for F frames)."""
    num_head = send_right_add(acc[..., l_out : l_out + d], acc[..., :d],
                              axis_name)
    num = jnp.concatenate([num_head, acc[..., d:l_out]], axis=-1)
    pvec = idx * l_out + jnp.arange(l_out, dtype=jnp.int32)
    head = jnp.asarray(head_np, dtype)
    tail = jnp.asarray(tail_np, dtype)
    hsel = head[jnp.clip(pvec, 0, d - 1)]
    tsel = tail[jnp.clip(pvec - (out_len - d), 0, d - 1)]
    norm = jnp.where(
        pvec < d, hsel,
        jnp.where(pvec < out_len - d, const, jnp.where(pvec < out_len, tsel, 1.0)),
    )
    return num / norm


def sharded_noise_gate(
    mesh: Mesh,
    nfft: int = 1024,
    hop: int = 256,
    threshold_db: float = 6.0,
    reduction_db: float = 60.0,
    noise_frames: int = 8,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
    release: float = 0.0,
) -> callable:
    """(C, N) -> (C, N) spectral noise gate == GateStage.full, channel+time
    sharded (configs 3/5)."""

    def local(x):
        return gate_shard_body(x, nfft, hop, threshold_db, reduction_db,
                               noise_frames, window_kind, impl,
                               release=release)

    return _smap(mesh, local)


# ---------------------------------------------------------------------------
# Sharded phase-vocoder time stretch (SURVEY.md §2 row 14)
# ---------------------------------------------------------------------------


def stretch_shard_body(
    x: jnp.ndarray,
    p: int,
    q: int,
    nfft: int,
    hop: int,
    window_kind: str = "hann",
    impl: str = fft_ops.DEFAULT_IMPL,
    axis_name: str = "time",
) -> jnp.ndarray:
    """Per-shard phase-vocoder time stretch at exact rational rate p/q;
    output == StretchStage.full(x) restricted to this shard's region.

    Cross-shard design: one frame of right halo covers every interpolation
    pair (the static local slot k_loc = (u*p)//q never exceeds m-1), the
    synthesis phase — a prefix sum of dphi over ALL synthesis frames — is
    completed with an all_gather of per-shard dphi totals (the
    associative_scan over shards, materialized), and phase0 broadcasts
    from shard 0 with a psum, like the gate's noise floor.  The OLA spill
    rides the same send_right_add as the sharded gate.
    """
    dtype = x.dtype
    d = nfft - hop
    l = x.shape[-1]
    check(l % hop == 0 and l >= nfft, "shard length must be >= nfft, hop-aligned")
    m = l // hop
    check((m * q) % p == 0, f"shard frames {m} * q must be a multiple of p={p}")
    mo = m * q // p
    r = nfft // hop
    check(mo >= r, f"shard emits {mo} synthesis frames < nfft/hop={r}")
    n_sh = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    n_glob = l * n_sh
    nf_glob = 1 + (n_glob - nfft) // hop
    nof = (((nf_glob - 1) * q - 1) // p) + 1
    from audiosignalprocess_tpu.effects.phase_vocoder import (
        cumrotor, unit_rotor,
    )

    w = jnp.asarray(window_np(window_kind, nfft), dtype)
    ext = halo_right(x, nfft, axis_name)  # d + hop halo -> m+1 local frames
    frames = frame_op(ext, nfft, hop)
    spec = fft_ops.rfft(frames * w, impl=impl)  # (..., m+1, nbins)
    # z0 rotor (unit(global frame 0)) broadcast from shard 0, planar psum
    f0r, f0i = unit_rotor(jnp.real(spec[..., 0:1, :]).astype(dtype),
                          jnp.imag(spec[..., 0:1, :]).astype(dtype))
    z0r = lax.psum(jnp.where(idx == 0, f0r, jnp.zeros_like(f0r)), axis_name)
    z0i = lax.psum(jnp.where(idx == 0, f0i, jnp.zeros_like(f0i)), axis_name)
    # static local analysis slots: global i = idx*mo + u -> k = idx*m + ks[u]
    ks = np.asarray([(u * p) // q for u in range(mo)])
    fr = np.asarray([((u * p) % q) / q for u in range(mo)])
    s0 = spec[..., jnp.asarray(ks), :]
    s1 = spec[..., jnp.asarray(ks + 1), :]
    i_glob = idx * mo + jnp.arange(mo, dtype=jnp.int32)
    emit = (i_glob < nof).astype(dtype)[:, None]
    # advance rotors (masked frames neutral so shard products compose)
    s0r, s0i = jnp.real(s0).astype(dtype), jnp.imag(s0).astype(dtype)
    s1r, s1i = jnp.real(s1).astype(dtype), jnp.imag(s1).astype(dtype)
    ur, ui = unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
    ur = jnp.where(emit > 0, ur, 1.0)
    ui = jnp.where(emit > 0, ui, 0.0)
    cr, ci = cumrotor(ur, ui)
    totr, toti = cr[..., -1:, :], ci[..., -1:, :]
    # cross-shard prefix: product of earlier shards' rotor totals (the
    # associative scan over shards, via one all_gather)
    allR = lax.all_gather(totr, axis_name)
    allI = lax.all_gather(toti, axis_name)
    carr = jnp.ones_like(totr)
    cari = jnp.zeros_like(toti)
    for j in range(n_sh - 1):
        sel = (j < idx)
        br = jnp.where(sel, allR[j], jnp.ones_like(totr))
        bi = jnp.where(sel, allI[j], jnp.zeros_like(toti))
        carr, cari = carr * br - cari * bi, carr * bi + cari * br
    # exclusive local prefix seeded by z0 * carry
    er = jnp.concatenate([jnp.ones_like(cr[..., :1, :]), cr[..., :-1, :]],
                         axis=-2)
    ei = jnp.concatenate([jnp.zeros_like(ci[..., :1, :]), ci[..., :-1, :]],
                         axis=-2)
    sr_ = z0r * carr - z0i * cari
    si_ = z0r * cari + z0i * carr
    phr = sr_ * er - si_ * ei
    phi_ = sr_ * ei + si_ * er
    frac = jnp.asarray(fr, dtype)[:, None]
    mag = ((1.0 - frac) * jnp.abs(s0) + frac * jnp.abs(s1)).astype(dtype) * emit
    synth = (mag * (phr + 1j * phi_)).astype(spec.dtype)
    out_frames = fft_ops.irfft(synth, nfft, impl=impl) * w
    fr4 = out_frames.reshape(out_frames.shape[:-1] + (r, hop))
    rows = mo + r - 1
    acc = jnp.zeros(x.shape[:-1] + (rows, hop), dtype)
    for jj in range(r):
        acc = acc.at[..., jj : jj + mo, :].add(fr4[..., :, jj, :])
    acc = acc.reshape(x.shape[:-1] + (rows * hop,))[..., : mo * hop + d]
    head_np, tail_np, const = _gate_norms(nfft, hop, window_kind)
    return _spill_and_norm(acc, idx, mo * hop, d, nfft + (nof - 1) * hop,
                           head_np, tail_np, const, dtype, axis_name)


def sharded_time_stretch(mesh: Mesh, p: int, q: int, nfft: int = 1024,
                         hop: int = 256, window_kind: str = "hann",
                         impl: str = fft_ops.DEFAULT_IMPL) -> callable:
    """(C, N) -> (C, N*q/p) phase-vocoder stretch == StretchStage.full,
    channel+time sharded."""

    def local(x):
        return stretch_shard_body(x, p, q, nfft, hop, window_kind, impl)

    return _smap(mesh, local)


# ---------------------------------------------------------------------------
# Sharded whole-file chain (config 5 spatial form)
# ---------------------------------------------------------------------------


def chain_shard_body(chain, x: jnp.ndarray, axis_name: str = "time") -> jnp.ndarray:
    """Apply a pipeline.Chain to one (channel, time) shard with halos.
    Output == chain.full(x) restricted to this shard."""
    from audiosignalprocess_tpu.pipeline import (
        FIRGateStage, FIRStage, GateStage, ResampleStage, ResFIRGateStage,
        StretchStage,
    )

    # composite stages shard as their component composition (their envelope
    # tail is already the direct-FIR form: the overlap-save branch below
    # cannot take an abs-pre)
    stages = []
    for s in chain.stages:
        if isinstance(s, ResFIRGateStage):
            stages.append(s._res)
            s = s._fg
        if isinstance(s, FIRGateStage):
            stages += [s._fir, s._gate]
            if s._env is not None:
                stages.append(s._env)
        else:
            stages.append(s)

    for s in stages:
        if isinstance(s, FIRStage):
            t = len(s.h)
            src = jnp.abs(x) if s.pre == "abs" else x
            _check_halo(t - 1, src.shape[-1])
            ext = halo_left(src, t - 1, axis_name)
            hist = ext[..., : t - 1]
            if s.nfft is not None:
                check(s.pre is None, "abs-pre + overlap-save not supported")
                _check_halo(t - 1, x.shape[-1])
                x = overlap_save(x, s.h, s.nfft, history=hist, impl=s.impl)
            else:
                x = fir_direct(src, s.h, history=hist)
            if s.post_scale != 1.0:
                x = x * s.post_scale
        elif isinstance(s, ResampleStage):
            hl = history_len(len(s.h), s.up, s.down)
            _check_halo(hl, x.shape[-1])
            ext = halo_left(x, hl, axis_name)
            x = resample_poly(x, s.up, s.down, h=s.h, zero_phase=False,
                              history=ext[..., :hl])
        elif isinstance(s, GateStage):
            x = gate_shard_body(x, s.nfft, s.hop, s.threshold_db,
                                s.reduction_db, s.noise_frames,
                                s.window_kind, s.impl, axis_name,
                                release=s.release)
        elif isinstance(s, StretchStage):
            x = stretch_shard_body(x, s.p, s.q, s.nfft, s.hop,
                                   s.window_kind, s.impl, axis_name)
        else:
            raise NotImplementedError(f"sharded chain stage: {type(s).__name__}")
    return x


def sharded_chain(mesh: Mesh, chain) -> callable:
    """Sharded whole-file execution of a pipeline.Chain == chain.full(x)."""

    def local(x):
        return chain_shard_body(chain, x)

    return _smap(mesh, local)


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Pure channel sharding (config 3): P('channel', None)."""
    return NamedSharding(mesh, P("channel", None))
