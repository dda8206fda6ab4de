#!/usr/bin/env python
"""Config 5 (BASELINE.json:11): streaming 128-channel chain — polyphase
resample (160/147) + FIR bank + STFT noise gate + envelope demod — block
streaming with exact carry state, or time-block sharded whole-file
(SURVEY.md §3.4)."""

import functools
import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.parallel.launch import initialize
from audiosignalprocess_tpu.parallel.mesh import make_mesh, shard_audio
from audiosignalprocess_tpu.parallel.sharded import sharded_chain
from audiosignalprocess_tpu.pipeline import (
    Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage,
)
from audiosignalprocess_tpu.utils.validate import check
from tools.common import (
    gen_wav_path, load_or_make, maybe_write, report, snr_db, std_parser,
    timed, to_host,
)

RATE_IN, RATE_OUT = 44100, 48000
CHANNELS = 128
BLOCK = 147 * 64  # input block: divisible by down=147; output block 10240


def build_chain() -> Chain:
    return Chain([
        ResampleStage(up=160, down=147),
        FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
        GateStage(nfft=1024, hop=256, noise_frames=8),
        EnvelopeStage(oracle.design_fir(129, 0.01)),
    ])


def run_ring(chain, wav_path, block, channels, nblocks=None, resume=None,
             ckpt=None, logger=None, batch_blocks=1, warmup=False,
             drain=False):
    """Ring-buffer streaming: a native decode thread (asp_io.c WavReader)
    feeds the SPSC ring while the device runs the jitted chain step —
    host decode overlaps device compute (BASELINE.json:11).  ``resume``
    restarts from a saved carry checkpoint; ``ckpt=(path, at_block)``
    saves one mid-stream.  ``batch_blocks=K`` micro-batches the device
    dispatch: K blocks are popped at once and run through ONE jitted
    ``lax.scan`` over ``chain.step`` (identical carry semantics, K blocks
    of added latency) — on high-dispatch-cost transports this amortizes
    the per-call dispatch cost across K blocks.  ``warmup=True`` precompiles
    the jitted step(s) BEFORE the timed dispatch loop (lower+compile
    only, nothing executes, carries untouched) so the returned wall time
    measures streaming rather than first-call compilation.
    ``drain=True`` processes the ENTIRE file: the tail remainder is
    zero-padded to a whole block, extra zero blocks flush the carried
    latency, and the returned output is exactly
    ``chain.out_len(num_frames)`` samples aligned to position 0 —
    identical in length and (to streaming reassociation) content to
    ``chain.stream(x, block, drain=True)`` / ``chain.full_flush(x)``.
    Returns (output, blocks_processed, dispatch_seconds)."""
    import threading
    import time as _time

    import jax.numpy as jnp

    from audiosignalprocess_tpu.io.wav_native import RingBuffer, WavReader
    from audiosignalprocess_tpu.utils.checkpoint import load_carry, save_carry

    check(batch_blocks >= 1, "batch_blocks must be >= 1")
    reader = WavReader(wav_path)
    check(reader.channels == channels,
          f"WAV has {reader.channels} channels, expected {channels}")
    n_in = reader.num_frames
    total = n_in // block
    if drain:
        check(nblocks is None, "drain streams the whole file (no nblocks)")
        check(resume is None, "drain trims a full-stream output; run "
              "restart demos without --drain")
        nblocks = chain.drain_blocks(n_in, block)
        # arm end-of-file semantics BEFORE the step is traced (frames
        # straddling EOF masked, finite-file WOLA ramp-out); disarmed in
        # the finally below
        chain.arm_eof(n_in)
    elif nblocks is None or nblocks > total:
        nblocks = total
    check(nblocks >= 1, f"input has {n_in} frames < one {block}-frame block "
          f"— nothing to stream (use --drain to process short files)")
    try:
        ring = RingBuffer(channels, block * max(8, 2 * batch_blocks))
        states = chain.init_state((channels,), block, jnp.float32)
        start_block = 0
        if resume:
            states, start_block = load_carry(resume, states)
            check(start_block < nblocks,
                  f"checkpoint is at block {start_block} of {nblocks} — "
                  f"nothing left to resume")

        def producer():
            for _ in range(start_block):  # restart-from-block: skip processed
                reader.read_block(block)
            for _ in range(start_block, nblocks):
                blk = reader.read_block(block)
                if blk.shape[1] < block:
                    # file-tail remainder / past EOF (drain mode): zero-pad
                    # to a whole block — never reached without drain (nblocks
                    # <= num_frames // block there)
                    blk = np.concatenate(
                        [blk, np.zeros((channels, block - blk.shape[1]),
                                       np.float32)], axis=1)
                off = 0
                while off < blk.shape[1]:
                    pushed = ring.push(blk[:, off:])
                    off += pushed
                    if pushed == 0:
                        _time.sleep(0.0002)

        # donate the carry: every step writes its new carry in place of the
        # old one's HBM instead of allocating fresh buffers per block
        step = jax.jit(chain.step, donate_argnums=(0,))

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step_k(st, blocks):  # blocks: (K, C, block)
            return jax.lax.scan(lambda s, xb: chain.step(s, xb), st, blocks)

        if warmup:
            # lower+compile only — nothing executes, the donated carry
            # buffers are untouched; the actual first call re-traces but hits
            # the (in-process + persistent) compilation cache
            zb = jnp.zeros((channels, block), jnp.float32)
            step.lower(states, zb).compile()
            if batch_blocks > 1:
                step_k.lower(states, jnp.zeros((batch_blocks, channels, block),
                                               jnp.float32)).compile()

        # timing starts here: decode-thread fill + device dispatch, no
        # compilation (the ring capacity bounds the producer's head start to
        # max(8, 2K) blocks, so decode stays inside the measured window)
        t_loop = _time.perf_counter()
        th = threading.Thread(target=producer, daemon=True)
        th.start()
        outs = []
        bi = start_block
        while bi < nblocks:
            # never batch across a checkpoint boundary (state must exist at
            # exactly ckpt[1] processed blocks)
            stop = nblocks
            if ckpt is not None and bi < ckpt[1]:
                stop = min(stop, ckpt[1])
            # full batches only: a ragged tail scan would be a fresh compile
            # per distinct K, so the remainder runs single steps
            k = batch_blocks if stop - bi >= batch_blocks else 1
            while ring.readable < block * k:
                _time.sleep(0.0002)
            blk, _ = ring.pop(block * k)
            t0 = _time.perf_counter()
            if k > 1:
                xb = jnp.asarray(
                    blk.reshape(channels, k, block).transpose(1, 0, 2))
                states, ys = step_k(states, xb)
                y = np.moveaxis(np.asarray(ys), 0, -2).reshape(channels, -1)
            else:
                states, y = step(states, jnp.asarray(blk))
                y = np.asarray(y)
            outs.append(y)
            if logger is not None:
                logger.tick(int(blk.size), block_index=bi, blocks=k,
                            step_ms=round(1e3 * (_time.perf_counter() - t0), 3),
                            ring_fill=int(ring.readable))
            bi += k
            if ckpt is not None and bi == ckpt[1]:
                save_carry(ckpt[0], states, bi)
        th.join()
        dt = _time.perf_counter() - t_loop
    finally:
        reader.close()
        if drain:
            # EOF state is per-run: never leak armed stages into a
            # caller's later non-drain use of the same chain
            chain.disarm_eof()
    out = np.concatenate(outs, axis=-1)
    if drain and start_block == 0:
        out = out[..., chain.latency : chain.latency + chain.out_len(n_in)]
    return out, nblocks - start_block, dt


def main(argv=None) -> dict:
    p = std_parser(__doc__)
    p.add_argument("--mode", choices=("stream", "sharded", "ring"),
                   default="stream")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--demo-restart", action="store_true",
                   help="ring mode: checkpoint mid-stream, restart from the "
                        "saved block, verify the resumed tail matches")
    p.add_argument("--ring-batch", type=int, default=1, metavar="K",
                   help="ring mode: micro-batch K blocks per device call "
                        "(one lax.scan step; amortizes dispatch latency at "
                        "K blocks of added latency)")
    p.add_argument("--drain", action="store_true",
                   help="ring mode: process the ENTIRE file — zero-pad the "
                        "tail remainder, flush the carried latency, emit "
                        "exactly chain.out_len(num_frames) samples (matches "
                        "chain.full_flush)")
    args = p.parse_args(argv)
    initialize(args.coordinator, args.num_processes, args.process_id)

    x = load_or_make(args, channels=CHANNELS, rate=RATE_IN)
    chain = build_chain()
    lat = chain.build()

    if args.mode == "ring":
        from audiosignalprocess_tpu.utils.profiling import BlockLogger

        wav_path = args.input or gen_wav_path(CHANNELS, RATE_IN, args.seed)
        logger = BlockLogger() if args.json or args.bench else None
        out, nb, dt = run_ring(chain, wav_path, BLOCK, CHANNELS,
                               logger=logger, batch_blocks=args.ring_batch,
                               warmup=args.bench, drain=args.drain)
        if args.drain:
            x_host = np.asarray(x, dtype=np.float32)
        else:
            x_host = np.asarray(x[:, : nb * BLOCK], dtype=np.float32)
        snr = None
        if args.check:
            if args.drain:
                ref = np.asarray(jax.jit(
                    lambda v: chain.stream(v, BLOCK, drain=True))(
                        jax.numpy.asarray(x_host)))
                check(ref.shape == out.shape,
                      f"drain length mismatch: {ref.shape} vs {out.shape}")
            else:
                ref = np.asarray(jax.jit(lambda v: chain.stream(v, BLOCK))(
                    jax.numpy.asarray(x_host)))
            exact = np.array_equal(ref, out)
            snr = np.inf if exact else snr_db(
                ref.astype(np.float64) + 1e-30, out.astype(np.float64) + 1e-30)
            check(exact or snr >= 100.0, f"ring != stream: {snr:.1f} dB")
        if args.demo_restart:
            import tempfile as _tf

            ck = os.path.join(_tf.gettempdir(), "asp_cfg5_carry.npz")
            half = max(1, (x.shape[-1] // BLOCK) // 2)
            out_a, _, _ = run_ring(chain, wav_path, BLOCK, CHANNELS,
                                   ckpt=(ck, half),
                                   batch_blocks=args.ring_batch)
            out_b, _, _ = run_ring(chain, wav_path, BLOCK, CHANNELS,
                                   resume=ck, batch_blocks=args.ring_batch)
            tail = out_a[..., half * chain.out_block(BLOCK):]
            check(np.array_equal(tail, out_b), "restart-from-block mismatch")
            print(f"  restart-from-block verified: resumed at block {half}, "
                  f"{out_b.shape[-1]} samples identical")
        maybe_write(args, out, RATE_OUT)
        # dt is the TOTAL ring wall time for nb blocks (report computes
        # samples/s as total input samples / dt, so dt must cover the
        # whole input, not one block)
        tag = f"_b{args.ring_batch}" if args.ring_batch > 1 else ""
        return report(f"config5_streaming_{CHANNELS}ch_ring{tag}", x_host,
                      out, dt, snr, args)

    if args.mode == "stream":
        n = (x.shape[-1] // BLOCK) * BLOCK
        x = x[:, :n]
        x_host = np.asarray(x)
        fn = jax.jit(lambda v: chain.stream(v, BLOCK))
    else:
        ndev = len(jax.devices())
        tm = ndev
        per = 147 * 32
        n = (x.shape[-1] // (tm * per)) * (tm * per)
        x = x[:, :n]
        x_host = np.asarray(x)
        mesh = make_mesh(channel=1, time=tm)
        fn = sharded_chain(mesh, chain)
        x = shard_audio(x, mesh)

    out, dt = timed(fn, x) if args.bench else (fn(x), None)
    out = to_host(out)

    snr = None
    if args.check:
        full = np.asarray(jax.jit(chain.full)(jax.numpy.asarray(x_host[:2])))
        if args.mode == "stream":
            got = out[:2, lat:]
            snr = snr_db(full[:, : got.shape[-1]], got)
        else:
            snr = snr_db(full, out[:2])
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE_OUT)
    return report(f"config5_streaming_{CHANNELS}ch_{args.mode}", x_host, out,
                  dt, snr, args)


if __name__ == "__main__":
    main()
