"""Ahead-of-time serving artifacts on ``torch.export``.

Port of ``nwhead_tpu/utils/aot.py``. A serving callable of
``NWNet.make_serving_fn`` (normalize -> featurize -> the prepared or IVF
head) is exported once, as a ``torch.export`` program, to a directory with
its weights and its bank; a fresh process loads it with no model-building
code and runs it through the same hand-written kernels as the live path:

    fn = load_serving_artifact(path)   # on the device it was exported for
    log_probs = fn(query_batch)

Design notes:

* The callable's ``export_module`` hook builds its pipeline as an
  ``nn.Module`` (``NWNet.serving_module``) whose featurizer weights,
  projection, head parameters and bank are parameters and buffers, so they
  are stored tensors of the program, not constants of its graph (JAX's
  design note, ``aot.py:16-24``).
* Every kernel on the path is a ``torch.library`` custom op
  (``ops/library.py``): the program calls ``nwhead_torch::*`` ops, which
  run the kernel on a card and the plain version on the CPU. The program
  is specialized to the example batch's shape and dtype and to the device
  it was exported on: ``meta.json`` records the device (``"cuda"`` or
  ``"cpu"``), the card's capability (``"sm_90a"``, null on the CPU) and the
  kernels' source digest, and the loaders refuse another device. On a card
  the loader builds and loads the kernels' libraries before the first call.
* The format is a directory with ``program.pt2`` (``torch.export.save``)
  and ``meta.json``; no ``torch.compile`` and no AOTInductor.
* An artifact is a snapshot of the bank: export again after
  ``add_support`` / ``remove_support`` (the live callable reads the bank
  at call time).
* The mesh artifact (``export_mesh_serving_artifact``) is one program over
  the net's mesh: the featurizer on the net's device, each shard's
  partials (K2/K4/K5 ``partials``) on its device, the exact merge. Full
  mode only, as in JAX; a raw-mode sharded bank is prepared from its live
  rows at export. ``torch.export`` fixes each shard's device in the graph,
  so a loader's ``mesh=`` must name the devices it was exported on
  (another shape refuses with "does not match", other devices by name).

The loaders import this module, ``ops/library.py`` and what that needs
(``ops/``, ``parallel/mesh.py`` for a mesh): no ``nw/net.py``, no
``models/``, no dataset code.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops import library  # noqa: F401  registers the nwhead_torch ops

_PROGRAM = "program.pt2"
_META = "meta.json"
# The kernels' libraries a serving program runs: K2/K4/K5/K6, K7/K10, K9/K11.
_SERVING_LIBRARIES = ("nw_prepared", "vit_attn", "vit_mlp")


def _capability(device: torch.device) -> Optional[str]:
    """The card's architecture as the kernels are built for it (``sm_90a``
    on an H100), or None off a card."""
    if device.type != "cuda":
        return None
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _module_device(module: torch.nn.Module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    raise ValueError("the serving module holds no tensor")


def _export(module: torch.nn.Module, example_batch, out_dir: str, extra: Dict[str, Any],
            metadata: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Export ``module`` on a zero batch of ``example_batch``'s shape and
    dtype (on the module's device), save the program and ``meta.json``."""
    device = _module_device(module)
    dtype = _torch_dtype(example_batch.dtype)
    x = torch.zeros(tuple(example_batch.shape), dtype=dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (x,), strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM))
    meta = {
        "device": device.type,
        "capability": _capability(device),
        "kernels_digest": _cuda._digest(),
        "input_shape": list(x.shape),
        "input_dtype": str(dtype).replace("torch.", ""),
        "output": "log_probs (B, n_classes)",
        "torch_version": torch.__version__,
        "n_operand_leaves": len(program.state_dict) + len(program.constants),
        **extra,
        **(metadata or {}),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def export_serving_artifact(
    serving_fn: Callable,
    example_batch,
    out_dir: str,
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Export a ``NWNet.make_serving_fn`` callable (single device) to
    ``out_dir``.

    ``example_batch``: an array or tensor (or anything with ``.shape`` and
    ``.dtype``) of the serving input's shape and dtype: ``(64, 224, 224, 3)``
    uint8 for a callable built with ``normalize=...``, float32 otherwise.
    The program is specialized to it: export one artifact per batch size.
    Returns the metadata written to ``meta.json``."""
    build = getattr(serving_fn, "export_module", None)
    if build is None:
        raise ValueError(
            "not an exportable serving fn: pass the callable returned by "
            "NWNet.make_serving_fn on a single-device net; for a mesh (sharded) net use "
            "export_mesh_serving_artifact(net, ...) instead (the live mesh callable reads "
            "bank state per call)")
    return _export(build(), example_batch, out_dir, {}, metadata)


def export_mesh_serving_artifact(
    net,
    example_batch,
    out_dir: str,
    normalize=None,
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Export a mesh net's full-mode serving pipeline (``NWNet(mesh=...)``,
    precomputed) to ``out_dir``: one program over the mesh
    (``NWNet.mesh_serving_module``), the bank's shards and the weights
    stored tensors on their devices. ``normalize=(mean, std)`` folds the
    uint8 normalization in, as ``make_serving_fn`` does;
    ``example_batch.shape[0]`` must split over the mesh's data axis. A
    snapshot of the current bank."""
    module = net.mesh_serving_module(normalize)
    mesh = net.mesh
    extra = {
        "mesh_axis_names": list(mesh.shape),
        "mesh_shape": list(mesh.devices.shape),
        "nr_devices": int(mesh.size),
        "mesh_devices": [str(d) for d in mesh.devices.flat],
    }
    return _export(module, example_batch, out_dir, extra, metadata)


def _read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def _check_device(path: str, meta: Dict[str, Any]) -> torch.device:
    """The device the artifact runs on, or ``ValueError`` when this process
    has no such device (JAX's "lowered for" guard, ``aot.py:308-314``)."""
    exported = (meta.get("device"), meta.get("capability"))
    if exported[0] == "cuda" and torch.cuda.is_available():
        running = ("cuda", _capability(torch.device("cuda")))
    else:
        running = ("cpu", None)
    if exported != running:
        raise ValueError(
            f"{path!r} was exported for another device: {exported[0]} "
            f"({exported[1] or 'plain versions'}), and this process runs on {running[0]} "
            f"({running[1] or 'plain versions'}); re-export it on the target device")
    return torch.device(running[0])


def _load_program(path: str, device: torch.device):
    """The program's module, the kernels built and loaded first on a card
    (a build failure is loud, and the first request pays no compile). On a
    card TF32 is turned off for the process, as ``NWNet`` turns it off:
    the program's f32 convolutions and products then compute as the live
    path's."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        _cuda.build()
        for name in _SERVING_LIBRARIES:
            _cuda.load_library(name)
    return torch.export.load(os.path.join(path, _PROGRAM)).module()


def _callable(module, device: torch.device, meta: Dict[str, Any]) -> Callable:
    def fn(x) -> torch.Tensor:
        with torch.inference_mode():
            return module(torch.as_tensor(x).to(device))

    fn.meta = meta
    return fn


def load_serving_artifact(path: str) -> Callable:
    """Load a single-device artifact into a ``batch -> log-probs``
    callable: numpy arrays or tensors in (moved to the artifact's device),
    a tensor on that device out. Refuses a mesh artifact and another
    device. The callable carries the metadata as ``fn.meta``."""
    meta = _read_meta(path)
    if "mesh_shape" in meta:
        raise ValueError(f"{path!r} is a mesh (multi-device) artifact: load it with "
                         "load_mesh_serving_artifact")
    device = _check_device(path, meta)
    return _callable(_load_program(path, device), device, meta)


def load_mesh_serving_artifact(path: str, mesh=None) -> Callable:
    """Load a mesh artifact into a ``batch -> log-probs`` callable (the
    batch moved to the mesh's first device). ``mesh``: by default the mesh
    it was exported on; a given one must have its shape ("does not match"
    otherwise) and its devices, which the program fixes (another device
    list is refused by name). The callable carries ``fn.meta`` and
    ``fn.mesh``."""
    from nwhead_tpu_torch.parallel.mesh import make_mesh

    meta = _read_meta(path)
    if "mesh_shape" not in meta:
        raise ValueError(f"{path!r} is a single-device artifact: load it with "
                         "load_serving_artifact")
    _check_device(path, meta)
    devices = [torch.device(d) for d in meta["mesh_devices"]]
    if mesh is None:
        if devices[0].type == "cuda":
            needed = 1 + max(d.index or 0 for d in devices)
            if torch.cuda.device_count() < needed:
                raise ValueError(f"artifact needs {needed} CUDA devices; only "
                                 f"{torch.cuda.device_count()} available")
        mesh = make_mesh(*meta["mesh_shape"], devices=devices)
    else:
        if list(mesh.devices.shape) != list(meta["mesh_shape"]):
            raise ValueError(f"mesh {tuple(mesh.shape)}{tuple(mesh.devices.shape)} does not "
                             f"match the artifact's {meta['mesh_axis_names']}"
                             f"{meta['mesh_shape']}")
        given = [str(d) for d in mesh.devices.flat]
        if given != meta["mesh_devices"]:
            raise ValueError(f"mesh devices {given} are not the artifact's "
                             f"{meta['mesh_devices']}: the program fixes each shard's device; "
                             "re-export on these devices")
    fn = _callable(_load_program(path, devices[0]), devices[0], meta)
    fn.mesh = mesh
    return fn


def load_any_serving_artifact(path: str) -> Callable:
    """Load either kind: a mesh artifact through
    ``load_mesh_serving_artifact``, a single-device one through
    ``load_serving_artifact``. The one loader the CLI uses."""
    if "mesh_shape" in _read_meta(path):
        return load_mesh_serving_artifact(path)
    return load_serving_artifact(path)
