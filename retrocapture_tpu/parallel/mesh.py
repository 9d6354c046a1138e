"""Device-mesh parallelism for the frame pipeline.

The reference scales with a thread pipeline inside one process plus an
HTTP fan-out between hosts (SURVEY.md §2.8); the JAX equivalents:

* **data parallelism** — the frame batch axis sharded over the ``data``
  mesh axis (independent frames, zero cross-device traffic in the chain);
* **spatial parallelism** — the frame W axis sharded over ``space`` for
  frames too large for one device's working set; XLA inserts the
  halo/collective traffic for the separable-resample matmuls;
* **temporal streams** — PassFeedback/history presets serialize frames,
  so parallelism comes from sharding *independent streams* (one game
  feed per device) across ``data`` while ``lax.scan`` walks time.

All of it rides ``jax.sharding.Mesh`` + ``NamedSharding``; no manual
collectives are required for the stateless chain — the per-frame program
is embarrassingly parallel over batch, and XLA handles resharding when a
spatial axis is split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "frame_sharding",
    "replicated",
    "shard_frames",
    "DATA_AXIS",
    "SPACE_AXIS",
]

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(
    n_data: Optional[int] = None,
    n_space: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, space)`` mesh. Defaults to all visible devices on
    the data axis — the right layout for independent frame streams."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devs) // n_space
    use = n_data * n_space
    arr = np.array(devs[:use]).reshape(n_data, n_space)
    return Mesh(arr, (DATA_AXIS, SPACE_AXIS))


def frame_sharding(mesh: Mesh, *, spatial: bool = False) -> NamedSharding:
    """Sharding for a ``[B, H, W, C]`` frame batch: batch over ``data``,
    optionally W over ``space``."""
    if spatial:
        return NamedSharding(mesh, P(DATA_AXIS, None, SPACE_AXIS, None))
    return NamedSharding(mesh, P(DATA_AXIS, None, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_frames(frames, mesh: Mesh, *, spatial: bool = False):
    """Place a host frame batch onto the mesh, sharded over ``data`` (and
    optionally W over ``space``)."""
    return jax.device_put(frames, frame_sharding(mesh, spatial=spatial))
