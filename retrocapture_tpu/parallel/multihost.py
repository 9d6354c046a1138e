"""Multi-host distribution: the JAX answer to the reference's
`/raw` + `/meta` fan-out.

The reference distributes work across machines by publishing the
pre-shader MPEG-TS feed (`/raw`) plus a JSON control snapshot (`/meta`)
over its own HTTP server, and a second instance decodes and mirrors the
preset/parameters (streaming/HTTPServer.cpp, streaming/RemoteMetaSync.cpp,
docs/ARCHITECTURE.md:176-194). Across hosts the same roles map onto the
runtime itself:

* **media plane** (`/raw` analog): per-host frame queues feed
  host-local shards of a global ``jax.Array``; the network moves nothing
  for the stateless chain because every host processes the streams it
  captured —
  ``jax.make_array_from_process_local_data`` assembles the global batch.
* **control plane** (`/meta` analog): the preset path + parameter dict
  is tiny replicated state; ``broadcast_meta`` ships the coordinator's
  snapshot to every process (the RemoteMetaSync diff-and-apply loop
  collapses to one collective).

``init()`` wraps ``jax.distributed.initialize`` with an explicit
coordinator (``JAX_COORDINATOR``/num_processes/process_id): every
process then sees the global device set and ``parallel.mesh.make_mesh``
builds a cluster-wide (data, space) mesh.

Single-host meshes (including the driver's virtual-CPU mesh) work
unchanged: ``init`` is a no-op when no coordinator is configured.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["init", "is_distributed", "global_frame_batch", "broadcast_meta"]


def init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host runtime. Arguments default from the
    environment (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). Returns True when running distributed, False
    for the single-host no-op (no coordinator configured)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_frame_batch(local_frames: np.ndarray, mesh) -> jax.Array:
    """Assemble each host's locally-captured frames into one global
    batch sharded over the mesh's ``data`` axis — the media-plane handoff
    replacing the reference's `/raw` HTTP hop. ``local_frames`` is this
    process's ``[B_local, H, W, C]``; the global batch is
    ``[B_local * num_processes, H, W, C]`` with every shard staying on
    the host that produced it (no DCN for stateless chains)."""
    from retrocapture_tpu.parallel.mesh import frame_sharding

    sharding = frame_sharding(mesh)
    if jax.process_count() == 1:
        return jax.device_put(local_frames, sharding)
    return jax.make_array_from_process_local_data(sharding, local_frames)


def broadcast_meta(meta: Optional[dict], *, source: int = 0) -> dict[str, Any]:
    """Replicate the control snapshot (preset path, parameter values —
    the `/meta` JSON analog, APIController.cpp:1352-1414) from ``source``
    to every process. Non-source processes pass None and receive the
    coordinator's snapshot; single-host returns the input unchanged."""
    if jax.process_count() == 1:
        return meta or {}
    from jax.experimental import multihost_utils

    payload = json.dumps(meta or {}, sort_keys=True)
    buf = np.zeros(65536, np.uint8)
    raw = payload.encode()
    if jax.process_index() == source:
        if len(raw) > buf.size:
            raise ValueError("meta snapshot exceeds 64 KiB broadcast buffer")
        buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    out = multihost_utils.broadcast_one_to_all(buf, is_source=jax.process_index() == source)
    data = bytes(np.asarray(out)).rstrip(b"\x00")
    return json.loads(data.decode() or "{}")
