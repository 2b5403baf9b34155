"""Data-parallel replicas of a module in one process.

The port's counterpart of what GSPMD and ``shard_map`` do for the JAX
package's data axis (``NWTrainer(mesh=)``, ``bn_axis_name``). One process
drives a list of devices, which may repeat one device (``parallel/mesh.py``):

* ``replicate(module, device)`` gives a replica whose parameters are the
  module's own moved there by ``.to`` (the module itself on its own
  device), so the gradients of every replica land on the one set of
  parameters;
* ``run_replicas`` runs one replica a thread, in lockstep where their
  BatchNorms sync (``models.resnet.ReplicaGroup``: each train-mode layer
  waits for every replica's sums before it normalizes), as
  ``torch.nn.parallel.parallel_apply`` runs one a device. Only the forward
  waits: the cross-replica sums are differentiable ops, so the backward is
  autograd's, with no barrier (one device's backward runs on one thread,
  so a barrier there would deadlock ``[cuda:0] * 4``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from nwhead_tpu_torch.models.resnet import BatchNorm2d, ReplicaGroup, replica_context


def same_device(a, b) -> bool:
    """``torch.device("cuda")`` and ``cuda:<current>`` are one device."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index or None in (a.index, b.index)
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def module_device(module: nn.Module) -> Optional[torch.device]:
    p = next(module.parameters(), None)
    return None if p is None else p.device


def replicate(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device``: itself when its parameters are there, else a
    shallow replica (``nn.Module._replicate_for_data_parallel``) whose
    parameters are the module's moved by ``.to(device)``, differentiable
    back to them, and whose buffers are copies; each ``BatchNorm2d`` replica
    updates the module's own running statistics (``_master``)."""
    home = module_device(module)
    if home is None or same_device(home, device):
        return module
    device = torch.device(device)
    copies = {}

    def copy(m: nn.Module) -> nn.Module:
        if id(m) in copies:
            return copies[id(m)]
        r = m._replicate_for_data_parallel()
        copies[id(m)] = r
        for name, child in m._modules.items():
            r._modules[name] = None if child is None else copy(child)
        for name, p in m._parameters.items():
            r.__dict__[name] = None if p is None else p.to(device)
        for name, b in m._buffers.items():
            r._buffers[name] = None if b is None else b.to(device)
        if isinstance(m, BatchNorm2d):
            r.__dict__["_master"] = m
        return r

    return copy(module)


def _on_device(device: torch.device):
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_replicas(fn: Callable, replicas: Sequence[nn.Module], inputs: Sequence[tuple],
                 devices: Sequence, group: ReplicaGroup) -> List:
    """``[fn(replicas[r], *inputs[r]) for r]``, replica r on its own thread
    as rank r of ``group`` with ``devices[r]`` current, grad mode the
    caller's; one replica runs on the calling thread. A replica's error is
    raised here after every thread has stopped (the others are released
    from a BatchNorm's wait)."""
    n = len(replicas)
    if not n == len(inputs) == len(devices) == group.n:
        raise ValueError(f"{n} replicas, {len(inputs)} inputs, {len(devices)} devices, "
                         f"a group of {group.n}")
    grad = torch.is_grad_enabled()
    if grad and any(getattr(m, "memory_efficient", False) for m in replicas[0].modules()):
        # The recompute of a checkpointed layer runs in the backward, on no
        # replica's thread: its BatchNorm would see one replica's batch.
        raise NotImplementedError("data-parallel replicas with checkpointed layers "
                                  "(memory_efficient): build the model without it")
    results: List = [None] * n
    errors: List = [None] * n

    def work(rank: int) -> None:
        try:
            with torch.set_grad_enabled(grad), replica_context(group, rank), \
                    _on_device(devices[rank]):
                results[rank] = fn(replicas[rank], *inputs[rank])
        except BaseException as e:  # handed to the caller below
            errors[rank] = e
            group.abort()

    if n == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(r,), name=f"replica-{r}")
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        first = next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                     raised[0])
        raise first
    return results


def data_parallel(module: nn.Module, inputs: Sequence[torch.Tensor], devices: Sequence, *,
                  axis_name: str = "data") -> List:
    """``module(inputs[r])`` on ``devices[r]`` for every r, in lockstep
    threads: the train-mode BatchNorms whose ``axis_name`` is ``axis_name``
    (``load_model(..., bn_axis_name=...)``) sync their statistics across
    the replicas, the others keep each replica's own
    (``models.resnet.ReplicaGroup``). Returns each replica's output on its
    device."""
    replicas = [replicate(module, dev) for dev in devices]
    return run_replicas(lambda m, x: m(x), replicas,
                        [(x.to(dev),) for x, dev in zip(inputs, devices)], devices,
                        ReplicaGroup(len(devices), axis_name))
