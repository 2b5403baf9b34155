"""Input pipeline: minibatches, episodes, a device-resident image cache, and
host-to-device prefetch.

Port of ``nwhead_tpu/data/pipeline.py``. ``BatchLoader`` and
``EpisodicBatcher`` are numpy index math with the JAX package's generators,
so the same indices come out in the same order. ``device_images`` keeps an
in-memory, transform-free dataset on the device once (under the same
``NWHEAD_DEVICE_IMAGES_BYTES`` ceiling, 6 GiB by default), so a step ships
only indices. ``prefetch_to_device`` is a host iterator: a background thread
gathers the next batches into pinned buffers, and the copy to the device is
``non_blocking``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class BatchLoader:
    """Minibatch iterator over a dataset with ``gather``; ``shuffle``
    reshuffles each epoch, ``drop_last`` keeps every batch full."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.dataset.gather(idx), self.dataset.targets[idx]


def device_images(ds, device) -> Optional[torch.Tensor]:
    """The dataset's ``(N, H, W, C)`` images as one f32 tensor on
    ``device``, cached on the dataset object (so the trainer and the bank
    featurizer share one copy); ``None`` for a dataset with a transform or
    without an in-memory ``images`` array, or one above the byte ceiling
    ``NWHEAD_DEVICE_IMAGES_BYTES`` (6 GiB by default)."""
    if getattr(ds, "transform", None) is not None:
        return None
    images = getattr(ds, "images", None)
    if images is None:
        return None
    np_images = np.asarray(images)
    if np_images.size * 4 > int(os.environ.get("NWHEAD_DEVICE_IMAGES_BYTES", 6 * 1024 ** 3)):
        return None
    device = torch.device(device)
    cached = getattr(ds, "_device_images_cache", None)
    # Keyed on the images object itself (a strong reference) and the device,
    # so swapping ds.images cannot serve stale pixels.
    if cached is None or cached[0] is not images or cached[1] != device:
        tensor = torch.from_numpy(np.ascontiguousarray(np_images, dtype=np.float32)).to(device)
        cached = (images, device, tensor)
        ds._device_images_cache = cached
    return cached[2]


def _to_device(item, device, pin: bool):
    if isinstance(item, tuple):
        return tuple(_to_device(x, device, pin) for x in item)
    t = torch.from_numpy(np.ascontiguousarray(item))
    if pin:
        t = t.pin_memory()
    return t.to(device, non_blocking=pin)


def prefetch_to_device(iterator, device, size: int = 2):
    """Wrap a host iterator of numpy arrays (or tuples of them): a
    background thread gathers ``size`` items ahead into pinned buffers (CUDA
    devices only) and each is copied to ``device`` with ``non_blocking``.
    An error in the thread is raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(_to_device(item, device, pin) if pin else item)
        except BaseException as e:  # surface worker errors to the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item if pin else _to_device(item, device, False)


class EpisodicBatcher:
    """Query minibatches with their support episodes: each step draws a
    query batch from one permutation per epoch and asks the support engine
    for an episode conditioned on its labels."""

    def __init__(self, dataset, support_train, batch_size: int, seed: int = 0) -> None:
        self.dataset = dataset
        self.support_train = support_train
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def _episodes(self, steps: Optional[int]):
        n = len(self.dataset)
        order = self.rng.permutation(n)
        stop = (n // self.batch_size) * self.batch_size
        for count, start in enumerate(range(0, stop, self.batch_size)):
            if steps is not None and count >= steps:
                return
            qidx = order[start:start + self.batch_size]
            qy = self.dataset.targets[qidx]
            yield (qidx, qy, *self.support_train.get_support(qy))

    def epoch_indices(self, steps: Optional[int] = None):
        """Indices only: ``(qidx, qy, sidx, sy)`` per step, for a dataset
        whose images are on the device already."""
        for qidx, qy, sidx, sy, _sm in self._episodes(steps):
            yield qidx, qy, sidx, sy

    def epoch(self, steps: Optional[int] = None):
        """Gathered images: ``(qimg, qy, simg, sy, env per support row)``."""
        for qidx, qy, sidx, sy, sm in self._episodes(steps):
            yield self.dataset.gather(qidx), qy, self.dataset.gather(sidx), sy, sm
