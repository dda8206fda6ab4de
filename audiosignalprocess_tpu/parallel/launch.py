"""Multi-process bring-up (SURVEY.md §2 P6-P7, §3.5).

One process drives every GPU of its host: a single-host mesh needs no
``jax.distributed`` at all.  The comm layer is pure XLA collectives
(``ppermute``/``psum``/``all_gather`` under ``shard_map``), which XLA
hands to NCCL — over NVLink between the cards of one host.  Several
processes (several hosts, or the simulated hosts of
``tools/launch_multihost.py``) start ``jax.distributed`` only when told
where the coordinator is; nothing is guessed from the environment.
"""

from __future__ import annotations

import logging
import os

import jax

from audiosignalprocess_tpu.utils.validate import check

log = logging.getLogger("asp.launch")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Start ``jax.distributed`` when a coordinator is named; return
    whether it started.

    The coordinator is ``coordinator_address`` or, failing that, the
    ``JAX_COORDINATOR_ADDRESS`` environment variable.  With neither, or
    with ``num_processes == 1``, this is a single process and nothing
    starts; process arguments without a coordinator are an error.  Errors
    from ``jax.distributed.initialize`` propagate: there is no fallback
    to a single process.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes == 1:
        log.info("single process; skipping jax.distributed")
        return False
    if coordinator_address is None:
        check(num_processes is None and process_id is None,
              "num_processes/process_id given without a coordinator "
              "address (pass coordinator_address or set "
              "JAX_COORDINATOR_ADDRESS)")
        log.info("no coordinator named; single process")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed init: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def warmup(fn, *args) -> None:
    """Compile-and-run barrier: verifies collective connectivity at init."""
    out = fn(*args)
    jax.block_until_ready(out)
