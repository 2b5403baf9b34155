"""The device mesh: support-sharded serving and data-parallel training.

Port of ``nwhead_tpu/parallel/mesh.py``. The JAX package's mesh is single
controller: one process drives every device of a ``shard_map`` or a jitted
step over sharded arrays, and nothing in it runs across processes. The port
keeps that design: a ``Mesh`` is an ``(n_data, n_support, n_model)`` array
of ``torch.device``s that one process drives (``parallel/sharded_bank.py``,
``parallel/data_parallel.py``). A list of devices may name one device
several times: each entry is then a virtual shard on that device, as the JAX
tests' eight virtual CPU devices are (``devices=[torch.device("cpu")] * 8``),
or four shards on one card (``[cuda:0] * 4``).

The axes are JAX's: ``data`` splits query batches (data-parallel training,
``train/trainer.py``), ``support`` splits the support bank
(``ShardedSupportBank``), ``model`` splits a feature dimension (tensor
parallel: ``column_parallel_dense``). JAX's ``NamedSharding`` helpers
(``data_sharding``, ``support_sharding``, ``replicated``,
``model_sharding``) become plain functions that place a tensor's pieces:
each returns one tensor a mesh device, in ``mesh.devices.flat`` order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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


def _place(t: torch.Tensor, mesh: Mesh, axis: Optional[str], dim: int) -> List[torch.Tensor]:
    """``t`` split along ``dim`` into ``mesh.shape[axis]`` equal pieces, the
    piece of a device's coordinate on ``axis`` on that device (every device
    gets all of ``t`` when ``axis`` is None), in ``mesh.devices.flat``
    order."""
    if axis is None:
        return [t.to(dev) for dev in mesh.devices.flat]
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over the "
                         f"{axis} axis of {n}")
    pieces = t.chunk(n, dim)
    k = AXES.index(axis)
    return [pieces[idx[k]].to(mesh.devices[idx])
            for idx in np.ndindex(*mesh.devices.shape)]


def data_sharding(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Leading (batch) dimension split over the ``data`` axis."""
    return _place(t, mesh, "data", 0)


def support_sharding(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Rows split over the ``support`` axis (bank features, labels, mask)."""
    return _place(t, mesh, "support", 0)


def replicated(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """All of ``t`` on every device."""
    return _place(t, mesh, None, 0)


def model_sharding(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """The feature (last) dimension split over the ``model`` axis: a Dense
    kernel's column slices, one a device."""
    return _place(t, mesh, "model", t.dim() - 1)


def column_parallel_dense(mesh: Mesh, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``x``'s rows split over ``data`` and ``w``'s columns
    over ``model`` (a column-parallel Dense): the device at (d, 0, m)
    computes rows d by columns m, and the output's tiles are gathered on the
    mesh's first device. The ``support`` axis would repeat the same tiles,
    so each is computed once, on its row's first support device."""
    xs, ws = data_sharding(mesh, x), model_sharding(mesh, w)
    n_data, _, n_model = mesh.devices.shape
    home = mesh.devices.flat[0]

    def tile(d: int, m: int) -> torch.Tensor:
        i = np.ravel_multi_index((d, 0, m), mesh.devices.shape)
        return (xs[i] @ ws[i]).to(home)

    return torch.cat([torch.cat([tile(d, m) for m in range(n_model)], dim=-1)
                      for d in range(n_data)])
