"""Carry weights from the JAX package's trees into the port's modules.

The inverse of ``nwhead_tpu/models/torch_import.py:convert_state_dict`` for
ResNets: a Flax ``{'params', 'batch_stats'}`` featurizer tree (numpy leaves)
becomes a torchvision-named ``state_dict``.

* conv kernels HWIO -> OIHW;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* ``layerK_i/{conv1,bn1,conv2,bn2,ds_conv,ds_bn}`` ->
  ``layerK.i.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``.

``jax_to_torch_nwmodel`` converts a whole ``NWModel`` tree: the featurizer,
the optional ``proj`` Dense layer (kernel ``(in, out)`` -> Linear weight
``(out, in)``) and the head's ``logit_scale``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_SUB = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}


def _module_name(path: str) -> str:
    m = re.fullmatch(r"layer(\d)_(\d+)/(\w+)", path)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}.{_SUB.get(m.group(3), m.group(3))}"
    if path in ("conv1", "bn1"):
        return path
    raise KeyError(f"not a ResNet module path: {path!r}")


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def jax_to_torch_resnet(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ResNet ``{'params': ..., 'batch_stats': ...}`` -> ``state_dict``
    for ``nwhead_tpu_torch.models.resnet.ResNet``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables_np["params"]):
        mod, leaf = path.rsplit("/", 1)
        name = _module_name(mod)
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            sd[f"{name}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unhandled parameter {path!r}")
    for path, arr in _flatten(variables_np.get("batch_stats", {})):
        mod, leaf = path.rsplit("/", 1)
        name = _module_name(mod)
        stat = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{name}.{stat}"] = torch.from_numpy(arr.copy())
        sd.setdefault(f"{name}.num_batches_tracked", torch.tensor(0, dtype=torch.long))
    return sd


def jax_to_torch_head(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The NW head's parameters (clip's ``logit_scale``; none for the other
    kernels) as a ``state_dict`` for ``nwhead_tpu_torch.nw.head.NWHead``."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params_np.items()
            if k == "logit_scale"}


def jax_to_torch_nwmodel(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``NWModel`` tree ``{'params': {featurizer, proj?, head?},
    'batch_stats': {featurizer}}`` -> ``state_dict`` for
    ``nwhead_tpu_torch.nw.net.NWModel``."""
    params = variables_np["params"]
    sd = {f"featurizer.{k}": v for k, v in jax_to_torch_resnet({
        "params": params["featurizer"],
        "batch_stats": variables_np.get("batch_stats", {}).get("featurizer", {}),
    }).items()}
    if "proj" in params:
        sd["proj.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params["proj"]["kernel"], np.float32).T))
        sd["proj.bias"] = torch.from_numpy(np.asarray(params["proj"]["bias"], np.float32).copy())
    sd.update({f"head.{k}": v for k, v in jax_to_torch_head(params.get("head", {})).items()})
    return sd
