"""Host-side frame pipeline: bounded queue + double-buffered device feed
and async device→host readback.

JAX equivalents of three reference components:

* the capture thread's bounded frame queue with drop-oldest overflow
  (VideoCaptureRemote.h:182-188, ~20 frames);
* FrameProcessor's CPU→GPU upload (processing/FrameProcessor.cpp:43) —
  here ``jax.device_put`` of batched uint8 frames, overlapped with
  compute by keeping one batch in flight;
* PBOManager's double-buffered async readback (renderer/PBOManager.cpp:
  86-170) — ``DeviceReadback`` returns the *previous* batch while the
  current one is still materializing on device, one frame of latency by
  design; JAX device arrays are futures, so ``np.asarray`` on last
  round's output only blocks if the device hasn't caught up.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator, Optional

import jax
import numpy as np

__all__ = ["FrameQueue", "DeviceFeeder", "DeviceReadback"]


class FrameQueue:
    """Thread-safe bounded FIFO of frames with drop-oldest overflow."""

    def __init__(self, maxlen: int = 20):
        self._dq: collections.deque = collections.deque()
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dropped = 0
        self.pushed = 0
        self._closed = False

    def push(self, frame: np.ndarray) -> None:
        with self._lock:
            if len(self._dq) >= self.maxlen:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(frame)
            self.pushed += 1
            self._not_empty.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        with self._not_empty:
            if not self._dq and not self._closed:
                self._not_empty.wait(timeout)
            if not self._dq:
                return None
            return self._dq.popleft()

    def pop_batch(self, n: int, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Block until n frames are available (or closed); returns [n,...]."""
        out = []
        while len(out) < n:
            f = self.pop(timeout)
            if f is None:
                if self._closed or timeout is not None:
                    break
                continue
            out.append(f)
        if len(out) < n:
            return None
        return np.stack(out)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


class DeviceFeeder:
    """Double-buffered host→device transfer: ``put`` returns the device
    array for the *current* batch while the previous one is likely still
    processing, letting H2D DMA overlap device compute."""

    def __init__(self, sharding=None):
        self._sharding = sharding
        self._inflight = None

    def put(self, batch: np.ndarray) -> jax.Array:
        if self._sharding is not None:
            arr = jax.device_put(batch, self._sharding)
        else:
            arr = jax.device_put(batch)
        self._inflight = arr
        return arr


class DeviceReadback:
    """PBOManager-shaped async device→host readback: submit the current
    output, receive the previous one as NumPy. Needs >=2 submissions
    before data flows (PBOManager.cpp:137)."""

    def __init__(self):
        self._prev: Optional[jax.Array] = None

    def submit(self, device_array: jax.Array) -> Optional[np.ndarray]:
        prev, self._prev = self._prev, device_array
        if prev is None:
            return None
        return np.asarray(prev)

    def flush(self) -> Optional[np.ndarray]:
        prev, self._prev = self._prev, None
        return None if prev is None else np.asarray(prev)


def stream(
    source_frames: Iterator[np.ndarray],
    process: Callable[[np.ndarray], jax.Array],
    *,
    batch: int = 8,
) -> Iterator[np.ndarray]:
    """Drive a frame iterator through ``process`` in batches with one
    batch of pipeline latency (feeder + readback composed)."""
    feeder = DeviceFeeder()
    readback = DeviceReadback()
    buf: list[np.ndarray] = []
    for f in source_frames:
        buf.append(f)
        if len(buf) == batch:
            out = readback.submit(process(feeder.put(np.stack(buf))))
            buf.clear()
            if out is not None:
                yield from out
    if buf:
        out = readback.submit(process(feeder.put(np.stack(buf))))
        if out is not None:
            yield from out
    tail = readback.flush()
    if tail is not None:
        yield from tail
