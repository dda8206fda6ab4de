"""Tracing/profiling (SURVEY.md §5): jax.profiler + named scopes + a
JSON-lines block logger for the streaming pipeline.

The reference (single-threaded C) has no tracing; this is the JAX
equivalent: XProf/Perfetto traces via ``jax.profiler.trace``, per-stage
``named_scope`` annotation, and structured per-block throughput records.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

import jax

named_scope = jax.named_scope

log = logging.getLogger("asp")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XProf/Perfetto trace of the enclosed region."""
    with jax.profiler.trace(logdir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Host-side trace annotation (shows up in the profiler timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class BlockLogger:
    """JSON-lines throughput log for streaming runs (one record per block)."""

    def __init__(self, stream=None, every: int = 1):
        self.stream = stream
        self.every = every
        self._t0 = None
        self._block = 0

    def tick(self, samples: int, **extra) -> None:
        now = time.perf_counter()
        if self._t0 is not None and self._block % self.every == 0:
            dt = now - self._t0
            rec = {"block": self._block, "samples": samples,
                   "samples_per_s": round(samples / dt, 1), **extra}
            line = json.dumps(rec)
            if self.stream is not None:
                print(line, file=self.stream)
            else:
                log.info(line)
        self._t0 = now
        self._block += 1
