"""Asynchronous image logging: the port's counterpart of
contexture_nerf_tpu/core/imagewriter.py.

The loop thread never waits on a device-to-host copy, an encode or a disk
write. `submit` starts a non-blocking copy of each CUDA tensor into pinned
host memory on the current stream, records an event after it, and hands the
write to ONE worker thread, which waits on that event, then encodes and
writes. The device tensor is referenced until its copy is done. Callers
quantise on the card first (uint8 crosses the bus, not f32). Writes stay in
order (one worker); memory is bounded: submit() waits on the oldest pending
write once `max_pending` are in flight.

A failed write (the NaN/Inf image guard included) raises at the next
submit() or flush().
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque

import numpy as np
import torch


def start_host_copy(a):
    """A callable that returns `a` as a host numpy array. A CUDA tensor's
    copy starts here, ordered after the work queued on its stream."""
    if not torch.is_tensor(a):
        return lambda: np.asarray(a)
    if not a.is_cuda:
        return lambda: a.detach().numpy()
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    host.copy_(a.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(a.device))

    def get(src=a):  # src keeps the device tensor alive until the copy ends
        done.synchronize()
        return host.numpy()
    return get


class AsyncImageWriter:
    """One-worker asynchronous writer for log images."""

    def __init__(self, max_pending: int = 16):
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ctn-imgwriter")
        self._pending: Deque[Future] = deque()
        self._max_pending = max_pending
        self._lock = threading.Lock()

    def submit(self, array, write_fn: Callable[[np.ndarray], None]):
        """Queue `write_fn(host array)` on the worker thread. `array` is a
        tensor (a CUDA tensor's copy starts here), a numpy array, or a
        tuple/list of either (write_fn then receives a tuple of numpy
        arrays). Raises any exception of a previous write."""
        is_multi = isinstance(array, (tuple, list))
        items = tuple(array) if is_multi else (array,)
        getters = [start_host_copy(a) for a in items]

        def task():
            mats = tuple(g() for g in getters)
            write_fn(mats if is_multi else mats[0])

        with self._lock:
            self._reap()
            while len(self._pending) >= self._max_pending:
                self._pending.popleft().result()  # backpressure + raise
            self._pending.append(self._pool.submit(task))

    def _reap(self):
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()  # raise if the write failed

    def flush(self):
        """Wait until every queued write finished; re-raise the first
        failure. Call at loop and phase boundaries before reading what was
        written."""
        with self._lock:
            while self._pending:
                self._pending.popleft().result()

    def close(self):
        self.flush()
        self._pool.shutdown(wait=True)


class _SyncWriter:
    """Runs each submission inline (log.async_image_writer: false)."""

    def submit(self, array, write_fn):
        if isinstance(array, (tuple, list)):
            write_fn(tuple(start_host_copy(a)() for a in array))
        else:
            write_fn(start_host_copy(array)())

    def flush(self):
        pass

    def close(self):
        pass


def sync_writer() -> _SyncWriter:
    """A writer that writes inline, raising at the logging call."""
    return _SyncWriter()
