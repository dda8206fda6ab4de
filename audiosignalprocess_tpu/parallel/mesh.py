"""Device mesh construction for (channel, time) sharding (SURVEY.md §2 P1-P2).

The framework's parallelism surface is DP(channel) x SP/CP(time):
- ``channel`` axis: independent channels, embarrassingly parallel.
- ``time`` axis: long recordings split into time blocks — the long-context
  mechanism; neighbor halos travel by ppermute (halo.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from audiosignalprocess_tpu.utils.validate import check


def make_mesh(channel: int = 1, time: int = 1, devices=None) -> Mesh:
    """(channel, time) mesh over the first channel*time devices.

    The shape follows the algorithm alone: NVLink joins the cards of a
    host all to all, so no device order is preferred.
    """
    if devices is None:
        devices = jax.devices()
    need = channel * time
    check(len(devices) >= need, f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(channel, time)
    return Mesh(arr, ("channel", "time"))


def audio_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for planar audio (channels, samples)."""
    return NamedSharding(mesh, P("channel", "time"))


def shard_audio(x, mesh: Mesh):
    """Place a (channels, samples) array onto the mesh."""
    return jax.device_put(x, audio_sharding(mesh))
