"""Composable processing chain + streaming block driver (SURVEY.md §3.4).

A ``Chain`` of stages supports two execution modes with EXACTLY matching
output streams:

- ``full(x)``   — whole-signal, one jit region, fully batched.
- ``stream``    — block-by-block with an explicit carry pytree (filter
  tails, OLA tails, resampler history, spectral FIFOs), the streaming
  structure of the reference's block loop (BASELINE.json:11).

Latency semantics: each streaming stage emits the stage's whole-signal
output stream right-shifted by ``latency`` zeros (causal stages: 0; STFT
stages: (nfft-hop) + noise_frames*hop).  ``Chain.build()`` propagates the
cumulative latency through rate changes and configures STFT stages to
skip latency-padding frames, so

    concat(stream blocks)[L:] == full(x)[: emitted-L]   (L = chain latency)

holds EXACTLY in structure (framing, lengths, block boundaries) and to
floating-point reassociation in numerics: streaming reorders the same
arithmetic (blockwise OLA partial sums, carried FIFO state), so f32
streams match full() to ~120 dB and f64 to ~1e-12 relative — not bit-for-
bit.  tests/unit/test_pipeline.py pins both bounds.

The carry pytree is checkpointable (utils/checkpoint.py) — streaming can
resume from any block index.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.effects.noise_gate import gate_mask, noise_gate
from audiosignalprocess_tpu.ops import fft as fft_ops
from audiosignalprocess_tpu.ops.fir import fir_direct
from audiosignalprocess_tpu.ops.overlap_save import overlap_save
from audiosignalprocess_tpu.ops.resample import history_len, resample_poly
from audiosignalprocess_tpu.ops.stft import frame as frame_op
from audiosignalprocess_tpu.ops.windows import window_np
from audiosignalprocess_tpu.utils.validate import check


def _wola_const_norm(nfft: int, hop: int, window_kind: str) -> float:
    """Interior WOLA norm (COLA constant: sum_k w^2[n-k*hop])."""
    w2 = window_np(window_kind, nfft) ** 2
    r = nfft // hop
    cols = np.sum(w2.reshape(r, hop), axis=0)
    check(np.allclose(cols, cols[0]), "window/hop is not COLA for w^2")
    return float(cols[0])


def _wola_head_norm(nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample WOLA norm over the first nfft-hop output samples (the
    ramp-in region of the whole-file istft)."""
    w2 = window_np(window_kind, nfft) ** 2
    d = nfft - hop
    norm = np.zeros(d)
    for k in range(d // hop + 1):
        lo = k * hop
        if lo >= d:
            break
        seg = min(nfft, d - lo)
        norm[lo : lo + seg] += w2[:seg]
    # clamp relative to the INTERIOR peak (oracle.WOLA_EDGE_REL), matching
    # the whole-file norm the oracle/ops paths compute — the head-local max
    # is itself a ramp value and would under-clamp
    const = _wola_const_norm(nfft, hop, window_kind)
    return np.maximum(norm, max(oracle.WOLA_EDGE_REL * const, 1e-12))


def _wola_tail_norm(nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample WOLA norm over the LAST nfft-hop output samples of a
    whole-file istft (the ramp-out region): position nout-d+i is covered
    by the final frames at window offsets hop+i, 2*hop+i, ... — the later
    frames that would complete the interior stack do not exist past
    end-of-file.  Used by drained streams (Chain.stream(drain=True)) to
    reproduce the oracle istft's finite-file edge normalization."""
    w2 = window_np(window_kind, nfft) ** 2
    d = nfft - hop
    norm = np.zeros(d)
    for i in range(d):
        norm[i] = w2[hop + i :: hop].sum()
    const = _wola_const_norm(nfft, hop, window_kind)
    return np.maximum(norm, max(oracle.WOLA_EDGE_REL * const, 1e-12))


def _wola_ola_emit(out_frames, ola_tail, hop, nfft, pvec, head_np, const,
                   dtype, eof_out=None, tail_np=None):
    """Blockwise WOLA synthesis shared by the gate and stretch jnp steps:
    overlap-add the synthesized frames with the d-sample tail carry, then
    normalize at output positions ``pvec`` (1.0 pre-signal, head ramp
    over [0, d), constant after; with ``eof_out`` set — a drained stream —
    the finite-file ramp-out over [eof_out-d, eof_out) and 1.0 past it).
    Returns (y, new_tail)."""
    d = nfft - hop
    r = nfft // hop
    m = out_frames.shape[-2]
    b_out = m * hop
    fr = out_frames.reshape(out_frames.shape[:-1] + (r, hop))
    rows = m + r - 1
    acc = jnp.zeros(out_frames.shape[:-2] + (rows, hop), dtype)
    for j in range(r):
        acc = acc.at[..., j : j + m, :].add(fr[..., :, j, :])
    acc = acc.reshape(out_frames.shape[:-2] + (rows * hop,))[..., : b_out + d]
    acc = acc.at[..., :d].add(ola_tail)
    head = jnp.asarray(head_np, dtype)
    idx = jnp.clip(pvec, 0, d - 1)
    norm = jnp.where(pvec < 0, 1.0,
                     jnp.where(pvec < d, head[idx],
                               jnp.asarray(const, dtype)))
    if eof_out is not None:
        tail = jnp.asarray(tail_np, dtype)
        ti = jnp.clip(pvec - (eof_out - d), 0, d - 1)
        norm = jnp.where(pvec >= eof_out, 1.0,
                         jnp.where(pvec >= eof_out - d, tail[ti], norm))
    return acc[..., :b_out] / norm, acc[..., b_out:]


class Stage:
    """Streaming stage protocol.  Latency is in output samples."""

    latency: int = 0

    def configure(self, input_latency: int) -> int:
        """Receive cumulative upstream latency (input samples of zeros
        prefixed to the true stream); return this stage's output latency."""
        self.input_latency = input_latency
        return input_latency + self.latency

    def out_block(self, b: int) -> int:
        return b

    def out_len(self, n: int) -> int:
        """Whole-file output length for input length ``n`` (the stage's
        rate map: ``len(full(x)) == out_len(len(x))`` for any x)."""
        return n

    def tail_width(self, t: int) -> int:
        """Tail span map for end-of-file draining: if the stage's input
        stream changes over its last ``t`` samples, at most the last
        ``tail_width(t)`` OUTPUT samples differ.  Causal sample-map
        stages: t.  Frame-based stages add their frame overlap.  Used to
        over-provision the drained stream's flush blocks."""
        return t

    # -- end-of-file semantics (drained streams) ---------------------------
    # Chain.stream(drain=True) arms each stage with the static length of
    # its REAL input before tracing the scan; frame-based stages then
    # invalidate frames straddling end-of-file and switch their emission
    # normalization to the finite-file ramp-out, so the drained stream
    # reproduces full()/the oracle exactly (not the zero-extended-input
    # semantics plain zero padding would give).  Causal sample-map stages
    # need nothing: zero padding past EOF is exact for them.

    _eof_n: int | None = None

    def set_eof(self, n_in: int) -> None:
        """Arm end-of-file handling: the real input occupies stream
        positions [input_latency, input_latency + n_in)."""
        self._eof_n = n_in

    def clear_eof(self) -> None:
        self._eof_n = None

    def full(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def init_state(self, batch: tuple, block: int, dtype):
        return ()

    def step(self, state, x):
        raise NotImplementedError


@dataclass
class FIRStage(Stage):
    """Causal FIR (direct or overlap-save when nfft given).  Latency 0."""

    h: np.ndarray
    nfft: int | None = None
    impl: str = fft_ops.DEFAULT_IMPL
    pre: str | None = None  # "abs" for envelope-style rectification
    post_scale: float = 1.0

    def _apply(self, x, history):
        if self.pre == "abs":
            x = jnp.abs(x)
        if self.nfft is not None:
            y = overlap_save(x, self.h, self.nfft, history=history,
                             impl=self.impl)
        else:
            y = fir_direct(x, self.h, history=history)
        return y * self.post_scale if self.post_scale != 1.0 else y

    def full(self, x):
        t = len(self.h)
        return self._apply(x, jnp.zeros(x.shape[:-1] + (t - 1,), x.dtype))

    def init_state(self, batch, block, dtype):
        return jnp.zeros(batch + (len(self.h) - 1,), dtype)

    def step(self, state, x):
        y = self._apply(x, state)
        t = len(self.h)
        if t == 1:  # stateless single-tap filter
            return state, y
        xin = jnp.abs(x) if self.pre == "abs" else x
        tail = jnp.concatenate([state, xin], axis=-1)[..., -(t - 1) :]
        return tail, y


def EnvelopeStage(h) -> FIRStage:
    """Envelope follower as a stage: |x| -> FIR lowpass -> *pi/2."""
    return FIRStage(h=np.asarray(h), pre="abs", post_scale=math.pi / 2.0)


@dataclass
class ResampleStage(Stage):
    """Causal polyphase rational resampler.  Latency 0 (group delay is
    inherent latency of the causal filter, not stream misalignment).
    Blocks and upstream latency must be multiples of ``down``."""

    up: int
    down: int
    h: np.ndarray | None = None

    def __post_init__(self):
        g = math.gcd(self.up, self.down)
        self.up //= g
        self.down //= g
        if self.h is None:
            self.h = oracle.resample_filter(self.up, self.down)
        self.h = np.asarray(self.h, dtype=np.float64)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.down == 0, f"upstream latency {input_latency} not a multiple of down={self.down}")
        self.input_latency = input_latency
        return input_latency * self.up // self.down

    def out_block(self, b):
        check(b % self.down == 0, f"block {b} not a multiple of down={self.down}")
        return b * self.up // self.down

    def out_len(self, n):
        return -(-n * self.up // self.down)

    def tail_width(self, t):
        return -(-t * self.up // self.down) + 1

    def full(self, x):
        return resample_poly(x, self.up, self.down, h=self.h,
                             zero_phase=False)

    def init_state(self, batch, block, dtype):
        return jnp.zeros(batch + (history_len(len(self.h), self.up, self.down),), dtype)

    def step(self, state, x):
        y = resample_poly(x, self.up, self.down, h=self.h, zero_phase=False,
                          history=state)
        hn = state.shape[-1]
        tail = jnp.concatenate([state, x], axis=-1)[..., -hn:] if hn else state
        return tail, y


@dataclass
class GateStage(Stage):
    """Streaming spectral noise gate (STFT -> mask -> WOLA ISTFT).

    Streaming design (see module docstring of ops/stft.py for framing):
    carries an input tail of nfft-hop samples, a spectral FIFO of
    ``noise_frames`` frames (so every frame is masked with the final noise
    floor, exactly as the whole-file gate), and the un-emitted OLA tail.
    Latency = (nfft-hop) + noise_frames*hop output samples.
    """

    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0  # one-pole mask release smoothing along frames
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    input_latency: int = 0

    def __post_init__(self):
        check(self.nfft % self.hop == 0, 'guard failed: self.nfft % self.hop == 0')
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0, f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self.input_latency = input_latency
        return input_latency + self.latency

    def tail_width(self, t):
        # the zero-pad tail of full() becomes true WOLA synthesis once
        # later frames exist: nfft-hop of overlap plus up to hop-1 of
        # frame truncation (inputs that fill no complete frame)
        return t + self.nfft - 1

    def full(self, x):
        """Whole-signal gate; output zero-padded back to input length so
        streaming and full shapes agree (gate output is nfft-hop shorter)."""
        y = noise_gate(
            x, self.nfft, self.hop, self.threshold_db, self.reduction_db,
            self.noise_frames, self.release, self.window_kind, self.impl,
        )
        pad = x.shape[-1] - y.shape[-1]
        return jnp.concatenate([y, jnp.zeros(x.shape[:-1] + (pad,), y.dtype)], axis=-1)

    # -- streaming ---------------------------------------------------------

    def _norm_const(self) -> float:
        return _wola_const_norm(self.nfft, self.hop, self.window_kind)

    def _head_norm(self) -> np.ndarray:
        return _wola_head_norm(self.nfft, self.hop, self.window_kind)

    def _tail_norm(self) -> np.ndarray:
        return _wola_tail_norm(self.nfft, self.hop, self.window_kind)

    def set_eof(self, n_in: int) -> None:
        d = self.nfft - self.hop
        check(n_in >= self.nfft, f"drain needs >= one complete frame "
              f"(nfft={self.nfft}), got {n_in} input samples — use full()")
        nframes = 1 + (n_in - self.nfft) // self.hop
        check(nframes >= self.noise_frames,
              f"signal has {nframes} frames < noise_frames={self.noise_frames}")
        nout = self.nfft + ((n_in - self.nfft) // self.hop) * self.hop
        check(nout >= 2 * d, f"drain needs disjoint WOLA edge ramps "
              f"(synthesis length {nout} < {2 * d}) — use full()")
        self._eof_n = n_in

    def _eof_nout(self) -> int | None:
        """Whole-file synthesis length (positions past it emit zeros)."""
        if self._eof_n is None:
            return None
        return self.nfft + ((self._eof_n - self.nfft) // self.hop) * self.hop

    def init_state(self, batch, block, dtype):
        check(block % self.hop == 0 and block >= self.hop, 'guard failed: block % self.hop == 0 and block >= self.hop')
        d = self.nfft - self.hop
        nbins = self.nfft // 2 + 1
        # the spectral FIFO is carried planar (re/im), the one carry
        # format of every spectral stage in this module
        st = dict(
            in_tail=jnp.zeros(batch + (d,), dtype),
            fifo_r=jnp.zeros(batch + (self.noise_frames, nbins), dtype),
            fifo_i=jnp.zeros(batch + (self.noise_frames, nbins), dtype),
            floor_sum=jnp.zeros(batch + (1, nbins), dtype),
            floor_n=jnp.zeros((), jnp.int32),
            ola_tail=jnp.zeros(batch + (d,), dtype),
            pos=jnp.zeros((), jnp.int32),  # stream position of block start
        )
        if self.release > 0.0:
            # release-smoothing state: s after the last emitted frame.
            # Zero init is exact: pad frames contribute at most `att`, and
            # release*att < att <= any mask value (see gate_mask).
            st["rel"] = jnp.zeros(batch + (1, nbins), dtype)
        return st

    def step(self, state, x):
        b = x.shape[-1]
        m = b // self.hop
        d = self.nfft - self.hop
        dtype = x.dtype
        w = jnp.asarray(window_np(self.window_kind, self.nfft), dtype)
        ext = jnp.concatenate([state["in_tail"], x], axis=-1)  # (..., b + d)
        frames = frame_op(ext, self.nfft, self.hop)  # (..., m, nfft)
        # stream-coordinate start of each new frame: pos - d + j*hop.
        # Validity is batch-independent (depends only on position).
        starts = state["pos"] - d + self.hop * jnp.arange(m, dtype=jnp.int32)
        # frames overlapping the latency padding carry no signal -> zero them
        valid_f = starts >= self.input_latency  # (m,)
        if self._eof_n is not None:
            # drained stream: frames straddling end-of-file are never
            # analyzed by the whole-file gate — invalidate them
            valid_f = jnp.logical_and(
                valid_f,
                starts + self.nfft <= self.input_latency + self._eof_n)
        spec = fft_ops.rfft(frames * w, impl=self.impl) * valid_f[:, None].astype(dtype)
        # noise floor: accumulate the first noise_frames valid frames
        mag = jnp.abs(spec).astype(dtype)
        take = jnp.logical_and(
            valid_f,
            state["floor_n"] + jnp.cumsum(valid_f.astype(jnp.int32)) <= self.noise_frames,
        )  # (m,)
        floor_sum = state["floor_sum"] + jnp.sum(
            mag * take[:, None].astype(dtype), axis=-2, keepdims=True
        )
        floor_n = (state["floor_n"] + jnp.sum(take.astype(jnp.int32))).astype(jnp.int32)
        # FIFO of depth noise_frames: pop oldest m, push m new.  Any frame
        # popped before the floor is final is a zero frame, so masking it
        # with a provisional floor is exact.  (Planar carry; see init_state.)
        buf_r = jnp.concatenate(
            [state["fifo_r"], jnp.real(spec).astype(dtype)], axis=-2)
        buf_i = jnp.concatenate(
            [state["fifo_i"], jnp.imag(spec).astype(dtype)], axis=-2)
        popped = (buf_r[..., :m, :] + 1j * buf_i[..., :m, :]).astype(spec.dtype)
        fifo_r = buf_r[..., m:, :]
        fifo_i = buf_i[..., m:, :]
        floor = floor_sum / self.noise_frames
        mask = gate_mask(jnp.abs(popped).astype(dtype), floor,
                         self.threshold_db, self.reduction_db)
        rel_state = None
        if self.release > 0.0:
            # s_q = max(mask_q, release * s_{q-1}) over the popped frames,
            # carried across blocks — matches the whole-file scan exactly
            # (zero/pad frames contribute <= att, absorbed by the max).
            s = state["rel"]
            rows = []
            for q in range(m):
                s = jnp.maximum(mask[..., q : q + 1, :], self.release * s)
                rows.append(s)
            mask = jnp.concatenate(rows, axis=-2)
            rel_state = s
        out_frames = fft_ops.irfft(popped * mask, self.nfft, impl=self.impl) * w
        # OLA + WOLA normalization: emitted samples are stream positions
        # [pos - latency, pos - latency + b); output position rel. true
        # stream start = p - input_latency; ramp for [0, d), const after.
        p0 = state["pos"] - self.latency - self.input_latency
        pvec = p0 + jnp.arange(b, dtype=jnp.int32)
        y, ola_tail = _wola_ola_emit(out_frames, state["ola_tail"],
                                     self.hop, self.nfft, pvec,
                                     self._head_norm(), self._norm_const(),
                                     dtype, eof_out=self._eof_nout(),
                                     tail_np=(None if self._eof_n is None
                                              else self._tail_norm()))
        new_state = dict(
            in_tail=ext[..., -d:],
            fifo_r=fifo_r,
            fifo_i=fifo_i,
            floor_sum=floor_sum,
            floor_n=floor_n,
            ola_tail=ola_tail,
            pos=(state["pos"] + b).astype(jnp.int32),
        )
        if rel_state is not None:
            new_state["rel"] = rel_state
        return new_state, y.astype(dtype)


@dataclass
class FIRGateStage(Stage):
    """FIR -> spectral-gate composite stage (the headline 48 kHz chain,
    BASELINE.json:2), optionally followed by an envelope demod.

    Exactly ``FIRStage(h, nfft) -> GateStage(nfft, hop, ...)`` (->
    ``EnvelopeStage(env_h)`` scaled by ``env_scale``): ``full``,
    ``init_state`` and ``step`` are those sub-stages' paths, composed.
    ``api.chain_file`` builds it, and a sharded chain splits it into the
    same sub-stages (parallel/sharded.chain_shard_body)."""

    h: np.ndarray = None
    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    input_latency: int = 0
    # optional envelope-demod tail (== a trailing EnvelopeStage(env_h):
    # |y| -> FIR lowpass -> *env_scale)
    env_h: np.ndarray | None = None
    env_scale: float = math.pi / 2.0

    def __post_init__(self):
        check(self.h is not None, "FIRGateStage requires filter taps h")
        self.h = np.asarray(self.h, np.float64)
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")
        check(self.nfft > len(self.h) - 1, "nfft must exceed taps-1")
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop
        self._fir = FIRStage(h=self.h, nfft=self.nfft, impl=self.impl)
        self._gate = GateStage(
            nfft=self.nfft, hop=self.hop, threshold_db=self.threshold_db,
            reduction_db=self.reduction_db, noise_frames=self.noise_frames,
            release=self.release, window_kind=self.window_kind,
            impl=self.impl)
        self._env = None
        if self.env_h is not None:
            self.env_h = np.asarray(self.env_h, np.float64)
            # direct form (== EnvelopeStage): valid for any tap count
            self._env = FIRStage(h=self.env_h, pre="abs",
                                 post_scale=self.env_scale, impl=self.impl)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0, f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self.input_latency = input_latency
        self._fir.configure(input_latency)
        self._gate.configure(input_latency)
        if self._env is not None:
            self._env.configure(input_latency + self.latency)
        return input_latency + self.latency

    def tail_width(self, t):
        return t + self.nfft - 1  # see GateStage.tail_width

    def set_eof(self, n_in):
        # the FIR front is a 1:1 causal map — the gate sees the same EOF
        self._gate.set_eof(n_in)
        self._eof_n = n_in

    def clear_eof(self):
        self._gate.clear_eof()
        self._eof_n = None

    def full(self, x):
        y = self._gate.full(self._fir.full(x))
        return y if self._env is None else self._env.full(y)

    def init_state(self, batch, block, dtype):
        check(block % self.hop == 0 and block >= self.hop, f"block {block} not a multiple of hop={self.hop}")
        st = [self._fir.init_state(batch, block, dtype),
              self._gate.init_state(batch, block, dtype)]
        if self._env is not None:
            st.append(self._env.init_state(batch, block, dtype))
        return st

    def step(self, state, x):
        sf, sg = state[0], state[1]
        sf, y = self._fir.step(sf, x)
        sg, y = self._gate.step(sg, y)
        if self._env is not None:
            se, y = self._env.step(state[2], y)
            return [sf, sg, se], y
        return [sf, sg], y


@dataclass
class ResFIRGateStage(Stage):
    """Resample -> FIR -> spectral-gate composite (the config-5 front half,
    BASELINE.json:11), optionally followed by an envelope demod.

    Exactly ``ResampleStage(up, down) -> FIRGateStage(h, nfft, hop, ...)``:
    ``full``, ``init_state`` and ``step`` are those sub-stages' paths,
    composed."""

    up: int = 160
    down: int = 147
    h: np.ndarray = None
    h_res: np.ndarray | None = None
    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    input_latency: int = 0
    # optional envelope-demod tail (see FIRGateStage): with it the stage
    # is the whole config-5 chain (resample + FIR + gate + envelope)
    env_h: np.ndarray | None = None
    env_scale: float = math.pi / 2.0

    def __post_init__(self):
        check(self.h is not None, "ResFIRGateStage requires filter taps h")
        g = math.gcd(self.up, self.down)
        self.up //= g
        self.down //= g
        if self.h_res is None:
            self.h_res = oracle.resample_filter(self.up, self.down)
        self.h_res = np.asarray(self.h_res, np.float64)
        if self.env_h is not None:
            self.env_h = np.asarray(self.env_h, np.float64)
        self._res = ResampleStage(up=self.up, down=self.down, h=self.h_res)
        self._fg = FIRGateStage(
            h=self.h, nfft=self.nfft, hop=self.hop,
            threshold_db=self.threshold_db, reduction_db=self.reduction_db,
            noise_frames=self.noise_frames, release=self.release,
            window_kind=self.window_kind, impl=self.impl,
            env_h=self.env_h, env_scale=self.env_scale)
        self.latency = self._fg.latency  # output (resampled) domain

    def configure(self, input_latency: int) -> int:
        lat_res = self._res.configure(input_latency)
        self.input_latency = lat_res  # gate-domain upstream latency
        return self._fg.configure(lat_res)

    def out_block(self, b: int) -> int:
        return self._fg.out_block(self._res.out_block(b))

    def out_len(self, n: int) -> int:
        return self._fg.out_len(self._res.out_len(n))

    def tail_width(self, t: int) -> int:
        return self._fg.tail_width(self._res.tail_width(t))

    def set_eof(self, n_in):
        # the gate frames the RESAMPLED stream; positions past the
        # resampler's rate-mapped EOF are phantom continuations of the
        # polyphase history and are never analyzed by full()
        self._fg.set_eof(self._res.out_len(n_in))
        self._eof_n = n_in

    def clear_eof(self):
        self._fg.clear_eof()
        self._eof_n = None

    def full(self, x):
        return self._fg.full(self._res.full(x))

    def init_state(self, batch, block, dtype):
        # name the INPUT-domain quantum in the error: the inner stages
        # would otherwise report the RESAMPLED block ("block 4800 not a
        # multiple of hop=256" for a user who passed 4410)
        k0 = self.hop // math.gcd(self.up, self.hop)
        quantum = self.down * k0
        check(block % quantum == 0,
              f"block {block} not a multiple of this chain's input quantum "
              f"{quantum} (= down*hop/gcd(up,hop): the resampled block "
              f"{self.up}/{self.down}*block must be a multiple of "
              f"hop={self.hop})")
        return [self._res.init_state(batch, block, dtype),
                self._fg.init_state(batch, self._res.out_block(block), dtype)]

    def step(self, state, x):
        sr_, sf_ = state
        sr_, y = self._res.step(sr_, x)
        sf_, y = self._fg.step(sf_, y)
        return [sr_, sf_], y


@dataclass
class StretchStage(Stage):
    """Streaming phase-vocoder time stretch at the EXACT rational rate
    p/q (analysis frames advanced per synthesis frame; p > q speeds up).

    Streaming design — all static shapes, no dynamic control flow
    (SURVEY.md §2 row 14):

    - Output frame i samples analysis position t_i = i*p/q.  With block
      frames m = block/hop such that m*q % p == 0, every block emits
      exactly mo = m*q/p synthesis frames.
    - The emission offset ``off`` (warm-up frames, = latency/hop) is
      chosen so frame availability holds for every block — and it makes
      the analysis-FIFO read positions for slot u BLOCK-INDEPENDENT:
      slot_u = D - m + n_skip + floor((u-off)*p/q), a static slice.
    - Phase accumulation (a prefix sum over synthesis frames) carries one
      per-bin accumulator; within a block it is a cumsum.
    - phase0 (the first true analysis frame's phase) is captured by a
      one-hot match on the physical frame counter.
    - WOLA synthesis reuses the gate's OLA-tail carry + head-ramp/const
      normalization (the stream never emits the finite-file tail ramp).

    Streaming contract: emitted[L:] == full(x)[:emitted-L] for all
    interior samples (positions < full's natural length minus nfft-hop;
    the whole-file tail ramp has no streaming counterpart).
    """

    p: int
    q: int
    nfft: int = 1024
    hop: int = 256
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    input_latency: int = 0

    def __post_init__(self):
        g = math.gcd(self.p, self.q)
        self.p //= g
        self.q //= g
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")

    @classmethod
    def from_rate(cls, rate: float, max_den: int = 64, **kw) -> "StretchStage":
        """Streaming stage for an arbitrary (incl. irrational) float rate.

        Streaming requires a rational p/q (static per-block frame counts);
        this picks the continued-fraction best approximation with
        denominator <= max_den — the rate error is < 1/(q*max_den), i.e.
        < 2.5e-4 at the default (inaudible next to the vocoder's own
        granularity; one synthesis frame drifts < hop/2 only after
        ~q*max_den frames).  Whole-file exact-float-rate processing is
        effects.time_stretch / pitch_shift."""
        from fractions import Fraction

        check(rate > 0 and math.isfinite(rate), "rate must be finite and > 0")
        f = Fraction(rate).limit_denominator(max_den)
        check(f.numerator > 0, f"rate {rate} too small for max_den={max_den}")
        return cls(p=f.numerator, q=f.denominator, **kw)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0, f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self.input_latency = input_latency
        d = self.nfft - self.hop
        # physical frames (starting at stream pos -d) before the first
        # true analysis frame
        self.n_skip = (input_latency + d) // self.hop
        # smallest block-independent warm-up satisfying
        # (mo-1-off)*p < (m - n_skip - 1)*q  for every block:
        self.off = -(-((self.n_skip + 1) * self.q + 1) // self.p) - 1
        self.latency = self.off * self.hop
        return self.latency

    def out_block(self, b: int) -> int:
        check(b % self.hop == 0, f"block {b} not a multiple of hop={self.hop}")
        m = b // self.hop
        check((m * self.q) % self.p == 0, f"block frames {m} * q must be a multiple of p={self.p}")
        return (m * self.q // self.p) * self.hop

    def out_len(self, n: int) -> int:
        return n * self.q // self.p

    def tail_width(self, t: int) -> int:
        # frame overlap + analysis-slot lookahead + frame truncation
        return -(-t * self.q // self.p) + self.nfft + self.hop

    def set_eof(self, n_in: int) -> None:
        d = self.nfft - self.hop
        check(n_in >= self.nfft + self.hop,
              f"drain needs >= two complete analysis frames "
              f"(nfft+hop={self.nfft + self.hop}), got {n_in} — use full()")
        nof = self._nof(n_in)
        check(self.nfft + (nof - 1) * self.hop >= 2 * d,
              "drain needs disjoint WOLA edge ramps — use full()")
        self._eof_n = n_in

    def _nof(self, n_in: int) -> int:
        """Oracle output frame count (phase_vocoder.stretch_steps_rational:
        output frame u interpolates analysis slots (k, k+1), so only
        nf-1 slot pairs exist for nf complete analysis frames)."""
        nf = (n_in - self.nfft) // self.hop + 1
        return 0 if nf < 2 else ((nf - 1) * self.q - 1) // self.p + 1

    def _eof_frames_out(self) -> int | None:
        return None if self._eof_n is None else self._nof(self._eof_n)

    def full(self, x):
        from audiosignalprocess_tpu.effects.phase_vocoder import (
            stretch_spec_rational,
        )
        from audiosignalprocess_tpu.ops.stft import istft, stft

        spec = stft(x, self.nfft, self.hop, self.window_kind, impl=self.impl)
        out = stretch_spec_rational(spec, self.p, self.q, self.nfft, self.hop)
        y = istft(out, self.nfft, self.hop, self.window_kind, impl=self.impl)
        target = x.shape[-1] * self.q // self.p
        pad = target - y.shape[-1]
        if pad > 0:
            y = jnp.concatenate(
                [y, jnp.zeros(y.shape[:-1] + (pad,), y.dtype)], axis=-1)
        return y[..., :target]

    # -- streaming ---------------------------------------------------------

    def _slots(self, m: int):
        """Static FIFO geometry for block frames m: (depth, slot[u], frac[u])."""
        mo = m * self.q // self.p
        co = -(-(self.off * self.p) // self.q)  # ceil(off*p/q)
        depth = max(m + co - self.n_skip, 2)
        ko = [( (u - self.off) * self.p) // self.q for u in range(mo)]
        fr = [(((u - self.off) * self.p) % self.q) / self.q for u in range(mo)]
        slots = [depth - m + self.n_skip + k for k in ko]
        check(all(0 <= s and s + 1 < depth for s in slots),
              f"internal: FIFO slot out of range (m={m})")
        return depth, np.asarray(slots), np.asarray(fr)

    def init_state(self, batch, block, dtype):
        m = block // self.hop
        self.out_block(block)  # validates alignment
        d = self.nfft - self.hop
        nbins = self.nfft // 2 + 1
        depth, _, _ = self._slots(m)
        # every carry planar (re/im), like GateStage's
        return dict(
            in_tail=jnp.zeros(batch + (d,), dtype),
            fifo_r=jnp.zeros(batch + (depth, nbins), dtype),
            fifo_i=jnp.zeros(batch + (depth, nbins), dtype),
            # rotor states (see effects.phase_vocoder rotor notes):
            # z0 = unit(first true frame), captured once; acc = running
            # product of per-frame advance rotors (neutral init)
            z0r=jnp.zeros(batch + (1, nbins), dtype),
            z0i=jnp.zeros(batch + (1, nbins), dtype),
            accr=jnp.ones(batch + (1, nbins), dtype),
            acci=jnp.zeros(batch + (1, nbins), dtype),
            ola_tail=jnp.zeros(batch + (d,), dtype),
            blk=jnp.zeros((), jnp.int32),
        )

    def step(self, state, x):
        b = x.shape[-1]
        m = b // self.hop
        mo = m * self.q // self.p
        d = self.nfft - self.hop
        dtype = x.dtype
        depth, slots, fr = self._slots(m)
        w = jnp.asarray(window_np(self.window_kind, self.nfft), dtype)
        ext = jnp.concatenate([state["in_tail"], x], axis=-1)
        frames = frame_op(ext, self.nfft, self.hop)  # (..., m, nfft)
        spec = fft_ops.rfft(frames * w, impl=self.impl)
        from audiosignalprocess_tpu.effects.phase_vocoder import (
            cumrotor, unit_rotor,
        )
        # capture z0 when the first true frame (physical n_skip) arrives
        phys = state["blk"] * m + jnp.arange(m, dtype=jnp.int32)
        hit = (phys == self.n_skip).astype(dtype)[:, None]
        spec_r = jnp.real(spec).astype(dtype)
        spec_i = jnp.imag(spec).astype(dtype)
        fur, fui = unit_rotor(spec_r, spec_i)
        z0r = state["z0r"] + jnp.sum(fur * hit, axis=-2, keepdims=True)
        z0i = state["z0i"] + jnp.sum(fui * hit, axis=-2, keepdims=True)
        fifo_r = jnp.concatenate([state["fifo_r"], spec_r],
                                 axis=-2)[..., -depth:, :]
        fifo_i = jnp.concatenate([state["fifo_i"], spec_i],
                                 axis=-2)[..., -depth:, :]
        # synthesis slots (static FIFO reads, planar)
        s0r = fifo_r[..., jnp.asarray(slots), :]
        s0i = fifo_i[..., jnp.asarray(slots), :]
        s1r = fifo_r[..., jnp.asarray(slots + 1), :]
        s1i = fifo_i[..., jnp.asarray(slots + 1), :]
        i_glob = state["blk"] * mo + jnp.arange(mo, dtype=jnp.int32) - self.off
        emit_f = i_glob >= 0
        nof = self._eof_frames_out()
        if nof is not None:
            # drained stream: output frames past the oracle's count
            # reference straddling analysis frames full() never
            # synthesizes — mask them (rotors stay neutral below)
            emit_f = jnp.logical_and(emit_f, i_glob < nof)
        emit = emit_f.astype(dtype)[:, None]
        # advance rotors u = unit(s1 conj s0); masked slots are neutral
        ur, ui = unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
        ur = jnp.where(emit > 0, ur, 1.0)
        ui = jnp.where(emit > 0, ui, 0.0)
        cr, ci = cumrotor(ur, ui)
        # exclusive prefix within the block, seeded by the carry rotor
        er = jnp.concatenate([jnp.ones_like(cr[..., :1, :]),
                              cr[..., :-1, :]], axis=-2)
        ei = jnp.concatenate([jnp.zeros_like(ci[..., :1, :]),
                              ci[..., :-1, :]], axis=-2)
        ar_, ai_ = state["accr"], state["acci"]
        pr_ = ar_ * er - ai_ * ei
        pi_ = ar_ * ei + ai_ * er
        phr = z0r * pr_ - z0i * pi_
        phi_ = z0r * pi_ + z0i * pr_
        accr = ar_ * cr[..., -1:, :] - ai_ * ci[..., -1:, :]
        acci = ar_ * ci[..., -1:, :] + ai_ * cr[..., -1:, :]
        frac = jnp.asarray(fr, dtype)[:, None]
        # hypot, not sqrt(r^2+i^2): matches jnp.abs(complex)'s accuracy
        # (the naive form measurably costs ~4 dB on stream==full parity)
        mag = ((1.0 - frac) * jnp.hypot(s0r, s0i)
               + frac * jnp.hypot(s1r, s1i))
        mag = mag * emit
        cdt = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        synth = (mag * (phr + 1j * phi_)).astype(cdt)
        out_frames = fft_ops.irfft(synth, self.nfft, impl=self.impl) * w
        # OLA + WOLA norm at whole-file-output positions (same helper as
        # GateStage.step)
        pvec = (state["blk"] * mo - self.off) * self.hop + jnp.arange(
            mo * self.hop, dtype=jnp.int32)
        y, ola_tail = _wola_ola_emit(
            out_frames, state["ola_tail"], self.hop, self.nfft, pvec,
            _wola_head_norm(self.nfft, self.hop, self.window_kind),
            _wola_const_norm(self.nfft, self.hop, self.window_kind), dtype,
            eof_out=(None if nof is None
                     else self.nfft + (nof - 1) * self.hop),
            tail_np=(None if nof is None else _wola_tail_norm(
                self.nfft, self.hop, self.window_kind)))
        new_state = dict(
            in_tail=ext[..., -d:],
            fifo_r=fifo_r,
            fifo_i=fifo_i,
            z0r=z0r,
            z0i=z0i,
            accr=accr,
            acci=acci,
            ola_tail=ola_tail,
            blk=(state["blk"] + 1).astype(jnp.int32),
        )
        return new_state, y.astype(dtype)


@dataclass
class Chain:
    """Sequential stage composition with whole-file and streaming modes."""

    stages: list = field(default_factory=list)

    def build(self) -> int:
        """Propagate latencies; returns total chain latency (output samples)."""
        lat = 0
        for s in self.stages:
            lat = s.configure(lat)
        self.latency = lat
        return lat

    def out_block(self, b: int) -> int:
        for s in self.stages:
            b = s.out_block(b)
        return b

    def out_len(self, n: int) -> int:
        """Rate-mapped whole-file output length: len(full(x)) for any x."""
        for s in self.stages:
            n = s.out_len(n)
        return n

    def tail_width(self) -> int:
        """Output samples at the end of ``full(x)`` that change once the
        input is extended past end-of-file (frame-based stages' zero-pad
        tails become true WOLA synthesis; see Stage.tail_width)."""
        t = 0
        for s in self.stages:
            t = s.tail_width(t)
        return t

    def full(self, x: jnp.ndarray) -> jnp.ndarray:
        for s in self.stages:
            x = s.full(x)
        return x

    def full_flush(self, x: jnp.ndarray) -> jnp.ndarray:
        """``full`` with the output length pinned to ``out_len(n)``.

        ``full`` already carries the complete finite-file answer — every
        stage's whole-file path analyzes exactly the complete frames of
        its input and edge-renormalizes the WOLA tail (the oracle istft
        semantics) — so no zero-extension is needed or wanted (extending
        the input would CHANGE the tail: straddling frames would be
        gated/stretched as real data).  This only pins the rate-mapped
        length for stages whose full() truncates or pads (e.g. the
        vocoder's frame-quantized istft length vs the n*q/p rate map).
        ``stream(x, block, drain=True)`` equals this to streaming
        reassociation for ANY input length and block size."""
        n = x.shape[-1]
        n_out = self.out_len(n)
        y = self.full(x)
        pad = n_out - y.shape[-1]
        if pad > 0:
            y = jnp.concatenate(
                [y, jnp.zeros(y.shape[:-1] + (pad,), y.dtype)], axis=-1)
        return y[..., :n_out]

    def init_state(self, batch: tuple, block: int, dtype=jnp.float32):
        self.build()
        states = []
        b = block
        for s in self.stages:
            states.append(s.init_state(batch, b, dtype))
            b = s.out_block(b)
        return states

    def step(self, states, x):
        new_states = []
        for s, st in zip(self.stages, states):
            st, x = s.step(st, x)
            new_states.append(st)
        return new_states, x

    def arm_eof(self, n: int) -> None:
        """Arm every stage's end-of-file semantics for a drained stream
        of ``n`` real input samples (see Stage.set_eof).  Callers running
        their own block loop over ``step`` (e.g. the config-5 ring
        driver) must arm BEFORE tracing the step and ``disarm_eof``
        after; ``stream(drain=True)`` does both internally."""
        m = n
        for s in self.stages:
            s.set_eof(m)
            m = s.out_len(m)

    def disarm_eof(self) -> None:
        for s in self.stages:
            s.clear_eof()

    def drain_blocks(self, n: int, block: int) -> int:
        """Total input blocks (>= ceil(n/block)) a drained stream must
        step so the emission covers positions [0, out_len(n)) past the
        chain latency AND every emitted position has converged (complete
        frame coverage).  Requires ``build()``."""
        n_out = self.out_len(n)
        ob = self.out_block(block)
        need = n_out + max(self.latency, self.tail_width())
        return max(-(-n // block), -(-need // ob))

    def stream(self, x: jnp.ndarray, block: int, drain: bool = False):
        """Run the whole signal through the block streamer with lax.scan.

        ``drain=False`` (the raw block loop): len(x) must be a multiple of
        ``block``; returns the emitted stream (len(x) mapped through rate
        changes).  Identity: emitted[L:] == full(x)[:emitted_len - L] —
        the final L samples of full(x) stay un-flushed in the carry.

        ``drain=True`` (end-of-file flush): ANY input length.  Internally
        zero-pads to ``drain_blocks`` whole blocks, arms every stage's
        end-of-file semantics (frames straddling EOF are invalidated and
        the WOLA emission switches to the finite-file ramp-out — see
        Stage.set_eof), streams, and returns exactly ``out_len(len(x))``
        samples aligned to position 0 (the latency prefix is stripped).
        Equals ``full_flush(x)`` / ``full(x)`` — the oracle's whole-file
        semantics including the synthesis tail — to streaming
        reassociation (~120 dB f32, ~1e-12 f64).
        """
        n = x.shape[-1]
        if drain:
            self.build()
            nblocks = self.drain_blocks(n, block)
            pad = nblocks * block - n
            if pad:
                x = jnp.concatenate(
                    [x, jnp.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
            try:
                self.arm_eof(n)
                y = self.stream(x, block)
            finally:
                self.disarm_eof()
            return y[..., self.latency : self.latency + self.out_len(n)]
        check(n % block == 0, "stream length must be a multiple of the block")
        nblocks = n // block
        states = self.init_state(x.shape[:-1], block, x.dtype)
        blocks = jnp.moveaxis(
            x.reshape(x.shape[:-1] + (nblocks, block)), -2, 0
        )  # (nblocks, ..., block)

        def body(st, xb):
            st, y = self.step(st, xb)
            return st, y

        _, ys = jax.lax.scan(body, states, blocks)
        return jnp.moveaxis(ys, 0, -2).reshape(
            x.shape[:-1] + (nblocks * self.out_block(block),)
        )
