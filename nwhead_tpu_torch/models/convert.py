"""Carry weights from the JAX package's trees into the port's modules.

The inverse of ``nwhead_tpu/models/torch_import.py:convert_state_dict`` for
ResNets: a Flax ``{'params', 'batch_stats'}`` featurizer tree (numpy leaves)
becomes a torchvision-named ``state_dict``.

* conv kernels HWIO -> OIHW;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* ``layerK_i/{conv1,bn1,conv2,bn2,ds_conv,ds_bn}`` ->
  ``layerK.i.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``.

``jax_to_torch_vit`` does the same for the flax ``VisionTransformer``:

* Dense kernels ``(in, out)`` -> Linear weights ``(out, in)``;
* the patch-embedding conv kernel HWIO -> OIHW;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``block{i}/...`` -> ``blocks.{i}....``; ``cls_token``, ``pos_embed``,
  ``ls1_gamma`` and ``ls2_gamma`` as named.

``jax_to_torch_nwmodel`` converts a whole ``NWModel`` tree: the featurizer
(a ResNet with its ``batch_stats``, or a ViT, which has none), the optional
``proj`` Dense layer and the head's ``logit_scale``.

``jax_to_torch_quantized_vit`` carries a JAX ``QuantizedViT``
(``nwhead_tpu/models/quantize.py``: int8 kernels ``(in, out)`` as they are,
their scales, the activation scales as floats, the bf16 HWIO patch kernel
to OIHW) into the port's ``QuantizedViT``, so that both run on identical
int8 weights and scales. It reads the arrays with ``np.asarray`` and
imports nothing of the JAX package.
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


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T))
    sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())


def _norm(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p["scale"]).copy())
    sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())


def jax_to_torch_vit(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` ``{'params': ...}`` (numpy leaves) ->
    ``state_dict`` for ``nwhead_tpu_torch.models.vit.VisionTransformer``."""
    params = variables_np["params"]
    sd: Dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    sd["patch_embed.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(pe["kernel"]).transpose(3, 2, 0, 1)))
    sd["patch_embed.bias"] = torch.from_numpy(np.asarray(pe["bias"]).copy())
    for name in ("cls_token", "pos_embed"):
        sd[name] = torch.from_numpy(np.asarray(params[name]).copy())
    _norm(sd, "norm", params["norm"])
    blocks = sorted((k for k in params if re.fullmatch(r"block\d+", k)), key=lambda k: int(k[5:]))
    for i, key in enumerate(blocks):
        if key != f"block{i}":
            raise KeyError(f"ViT blocks are not numbered 0..{len(blocks) - 1}: {blocks}")
        bp, pre = params[key], f"blocks.{i}"
        _norm(sd, f"{pre}.norm1", bp["norm1"])
        _norm(sd, f"{pre}.norm2", bp["norm2"])
        _dense(sd, f"{pre}.attn.qkv", bp["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", bp["attn"]["proj"])
        _dense(sd, f"{pre}.mlp.fc1", bp["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", bp["mlp"]["fc2"])
        for g in ("ls1_gamma", "ls2_gamma"):
            if g in bp:
                sd[f"{pre}.{g}"] = torch.from_numpy(np.asarray(bp[g]).copy())
    return sd


def jax_to_torch_head(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The NW head's parameters (clip's ``logit_scale``; none for the other
    kernels) as a ``state_dict`` for ``nwhead_tpu_torch.nw.head.NWHead``."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params_np.items()
            if k == "logit_scale"}


def jax_to_torch_nwmodel(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``NWModel`` tree ``{'params': {featurizer, proj?, head?},
    'batch_stats': {featurizer}}`` -> ``state_dict`` for
    ``nwhead_tpu_torch.nw.net.NWModel``; a ViT featurizer has no
    ``batch_stats``."""
    params = variables_np["params"]
    if "patch_embed" in params["featurizer"]:
        feat = jax_to_torch_vit({"params": params["featurizer"]})
    else:
        feat = jax_to_torch_resnet({
            "params": params["featurizer"],
            "batch_stats": variables_np.get("batch_stats", {}).get("featurizer", {}),
        })
    sd = {f"featurizer.{k}": v for k, v in feat.items()}
    if "proj" in params:
        _dense(sd, "proj", params["proj"])
    sd.update({f"head.{k}": v for k, v in jax_to_torch_head(params.get("head", {})).items()})
    return sd


def _np32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def jax_to_torch_quantized_vit(q: Any):
    """A JAX ``QuantizedViT`` (or any object with its fields: ``patch_w``
    HWIO, ``patch_b``, ``cls_token``, ``pos_embed``, ``patch_size``,
    ``num_heads``, ``blocks`` of ``QViTBlock`` fields, ``final_norm``) ->
    ``nwhead_tpu_torch.models.quantize.QuantizedViT`` on the CPU."""
    from nwhead_tpu_torch.models.quantize import QDense, QuantizedViT, QViTBlock

    def dense(d) -> QDense:
        return QDense(torch.from_numpy(np.asarray(d.wq, np.int8).copy()), _np32(d.w_scale),
                      _np32(d.bias), float(np.asarray(d.act_scale, np.float32)))

    def maybe(t):
        return None if t is None else _np32(t)

    blocks = [QViTBlock((_np32(b.norm1.scale), _np32(b.norm1.bias)), dense(b.qkv),
                        dense(b.proj), maybe(b.ls1), (_np32(b.norm2.scale), _np32(b.norm2.bias)),
                        dense(b.fc1), dense(b.fc2), maybe(b.ls2)) for b in q.blocks]
    patch_w = np.ascontiguousarray(np.asarray(q.patch_w, np.float32).transpose(3, 2, 0, 1))
    return QuantizedViT(torch.from_numpy(patch_w), _np32(q.patch_b), _np32(q.cls_token),
                        _np32(q.pos_embed), _np32(q.final_norm.scale), _np32(q.final_norm.bias),
                        int(q.patch_size), int(q.num_heads), blocks).eval()
