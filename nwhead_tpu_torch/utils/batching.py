"""Dynamic micro-batching in front of a batched serving callable.

Port of ``nwhead_tpu/utils/batching.py``. A deployment receives requests of
one image, but the device wants full batches: a head call on one query
costs about what one on 64 does, and every batch size is a shape of its
own. ``MicroBatcher`` sits between: callers submit items and get futures;
a collector thread takes up to ``max_batch`` items, in arrival order, when
the batch is full, when its oldest item has waited ``max_wait_ms``, or when
the batcher closes; a short batch is zero-padded to ``max_batch`` rows
and the padding rows are dropped on the way out.

Items and results are numpy arrays. The serving callable may return a
tensor on any device (``NWNet.make_serving_fn`` returns one on the net's
device): the collector thread reads it back to the host, which also waits
for the device to finish the batch.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch


def host_array(out) -> np.ndarray:
    """A serving callable's output as a host numpy array: a tensor is read
    back from its device (``.cpu().numpy()``), anything else through
    ``np.asarray``."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    """Coalesce concurrent single-item requests into fixed-shape batches.

    :param serve_fn: batched callable ``(B, ...) -> (B, C)`` (e.g. from
        ``NWNet.make_serving_fn``); always called with exactly
        ``max_batch`` rows.
    :param max_batch: the batch size the device serves.
    :param max_wait_ms: latency bound: a batch that is not full dispatches
        once its oldest item has waited this long.

    ``dispatches`` and ``dispatched_items`` count the batches taken and
    their items before padding; read them after ``close``.
    """

    def __init__(self, serve_fn: Callable, max_batch: int = 64,
                 max_wait_ms: float = 5.0) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._serve = serve_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._lock = threading.Condition()
        self._pending: list = []  # [(item, Future, arrival time), ...]
        self._closed = False
        self.dispatches = 0
        self.dispatched_items = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, item: np.ndarray) -> Future:
        """Enqueue one item (an ``(H, W, C)`` image or a ``(D,)`` feature);
        returns a future of that item's output row."""
        f: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append((np.asarray(item), f, time.monotonic()))
            self._lock.notify()
        return f

    def __call__(self, item: np.ndarray):
        """Submit and wait."""
        return self.submit(item).result()

    def close(self, timeout: float = 10.0) -> None:
        """Serve the pending items and stop the collector thread."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- collector -----------------------------------------------------------

    def _take_batch(self) -> Sequence:
        """Wait for items; return up to ``max_batch`` of them, oldest first,
        once the batch is full, its oldest item has waited ``max_wait`` (each
        item's arrival time is its clock, so batches formed while the
        collector was busy need no state of their own) or the batcher is
        closing with items left; ``[]`` once closed and empty."""
        with self._lock:
            while True:
                if self._pending:
                    oldest = self._pending[0][2]
                    if (len(self._pending) >= self.max_batch or self._closed
                            or time.monotonic() - oldest >= self.max_wait):
                        take = self._pending[:self.max_batch]
                        del self._pending[:len(take)]
                        return take
                    self._lock.wait(timeout=oldest + self.max_wait - time.monotonic())
                else:
                    if self._closed:
                        return []
                    self._lock.wait()

    def _run(self) -> None:
        while True:
            take = self._take_batch()
            if not take:
                return
            with self._lock:
                self.dispatches += 1
                self.dispatched_items += len(take)
            futs = [t[1] for t in take]
            try:
                batch = np.stack([t[0] for t in take])
                pad = self.max_batch - len(batch)
                if pad:  # one batch shape; the padding rows are dropped
                    batch = np.concatenate(
                        [batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
                out = host_array(self._serve(batch))
                for i, f in enumerate(futs):
                    f.set_result(out[i])
            except Exception as e:  # every caller of the batch gets the error
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
