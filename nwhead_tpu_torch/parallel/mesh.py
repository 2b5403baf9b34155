"""The device mesh of support-sharded serving.

Port of ``nwhead_tpu/parallel/mesh.py``. The JAX package's mesh is single
controller: one process drives every device of a ``shard_map``, and nothing
in it runs across processes. The port keeps that design: a ``Mesh`` is an
``(n_data, n_support, n_model)`` array of ``torch.device``s that one process
drives (``parallel/sharded_bank.py``). A list of devices may name one device
several times: each entry is then a virtual shard on that device, as the JAX
tests' eight virtual CPU devices are (``devices=[torch.device("cpu")] * 8``),
or four shards on one card (``[cuda:0] * 4``).

The ``model`` (tensor-parallel) axis and the ``NamedSharding`` helpers serve
data-parallel training, which is not ported yet (ROADMAP.md queue 1, item
14): ``n_model`` must be 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

AXES = ("data", "support", "model")


class Mesh:
    """Devices on the ``data`` x ``support`` x ``model`` axes."""

    def __init__(self, devices: np.ndarray) -> None:
        if devices.ndim != 3:
            raise ValueError(f"mesh devices must be (data, support, model), got {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    n_data: Optional[int] = None,
    n_support: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device), axes
    resolved as the JAX package resolves them: all devices on ``data`` when
    neither axis is given, else the missing axis takes the rest."""
    if n_model != 1:
        raise NotImplementedError(
            "the mesh's model (tensor-parallel) axis serves data-parallel training, which "
            "is not ported yet (ROADMAP.md queue 1, item 14): pass n_model=1")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0 or n % n_model:
        raise ValueError(f"{n} devices do not split over a model axis of {n_model}")
    n_rest = n // n_model
    if n_data is None and n_support is None:
        n_data, n_support = n_rest, 1
    elif n_data is None:
        n_data = n_rest // n_support
    elif n_support is None:
        n_support = n_rest // n_data
    if n_data * n_support * n_model != n:
        raise ValueError(f"mesh ({n_data}, {n_support}, {n_model}) needs "
                         f"{n_data * n_support * n_model} devices, got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_data, n_support, n_model))
