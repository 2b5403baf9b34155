"""Carry weights from the JAX package's trees into the port's modules.

The inverse of ``nwhead_tpu/models/torch_import.py:convert_state_dict`` for
the CNNs: a Flax ``{'params', 'batch_stats'}`` featurizer tree (numpy leaves)
becomes a ``state_dict`` in the port's (torchvision's) names.

* conv kernels HWIO -> OIHW;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* ResNets (``jax_to_torch_resnet``):
  ``layerK_i/{conv1,bn1,conv2,bn2,conv3,bn3,ds_conv,ds_bn,shortcut}`` ->
  ``layerK.i.{conv1,bn1,conv2,bn2,conv3,bn3,downsample.0,downsample.1,
  shortcut.0}``;
* ImageNet DenseNets (``jax_to_torch_densenet``): ``conv0``, ``norm0``,
  ``norm5``, ``denseblockK/denselayerJ/{norm1,conv1,norm2,conv2}`` and
  ``transitionK/{norm,conv}`` under ``features.``;
* the CIFAR DenseNet (``jax_to_torch_cifar_densenet``): ``conv1``,
  ``d{i}_{j}_{bn1,conv1,bn2,conv2}`` -> ``dense{i+1}.{j}.*``,
  ``t{i}_{bn,conv}`` -> ``trans{i+1}.*``, ``bn_final`` -> ``bn``.

``jax_to_torch_vit`` does the same for the flax ``VisionTransformer``:

* Dense kernels ``(in, out)`` -> Linear weights ``(out, in)``;
* the patch-embedding conv kernel HWIO -> OIHW;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``block{i}/...`` -> ``blocks.{i}....``; ``cls_token``, ``pos_embed``,
  ``ls1_gamma`` and ``ls2_gamma`` as named.

``jax_to_torch_relation`` converts the JAX ``RelationNetwork``'s convs,
BatchNorms (with their statistics) and Dense layers.

``jax_to_torch_nwmodel`` converts a whole ``NWModel`` tree: the featurizer
(a ResNet, a DenseNet or a CIFAR DenseNet with its ``batch_stats``, or a
ViT, which has none), the optional ``proj`` Dense layer and the head's
``logit_scale``.

``jax_to_torch_quantized_vit`` carries a JAX ``QuantizedViT``
(``nwhead_tpu/models/quantize.py``: int8 kernels ``(in, out)`` as they are,
their scales, the activation scales as floats, the bf16 HWIO patch kernel
to OIHW) into the port's ``QuantizedViT``, so that both run on identical
int8 weights and scales. It reads the arrays with ``np.asarray`` and
imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

_SUB = {"ds_conv": "downsample.0", "ds_bn": "downsample.1", "shortcut": "shortcut.0"}


def _resnet_module(path: str) -> str:
    m = re.fullmatch(r"layer(\d)_(\d+)/(\w+)", path)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}.{_SUB.get(m.group(3), m.group(3))}"
    if path in ("conv1", "bn1"):
        return path
    raise KeyError(f"not a ResNet module path: {path!r}")


def _densenet_module(path: str) -> str:
    if re.fullmatch(r"conv0|norm0|norm5|denseblock\d+/denselayer\d+/(norm|conv)[12]"
                    r"|transition\d+/(norm|conv)", path):
        return "features." + path.replace("/", ".")
    raise KeyError(f"not a DenseNet module path: {path!r}")


def _cifar_densenet_module(path: str) -> str:
    m = re.fullmatch(r"d(\d+)_(\d+)_(bn1|conv1|bn2|conv2)", path)
    if m:
        return f"dense{int(m.group(1)) + 1}.{m.group(2)}.{m.group(3)}"
    m = re.fullmatch(r"t(\d+)_(bn|conv)", path)
    if m:
        return f"trans{int(m.group(1)) + 1}.{m.group(2)}"
    if path in ("conv1", "bn_final"):
        return {"conv1": "conv1", "bn_final": "bn"}[path]
    raise KeyError(f"not a CIFAR DenseNet module path: {path!r}")


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _cnn_state_dict(variables_np: Mapping[str, Any],
                    module_name: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    """A flax CNN tree -> ``state_dict``, each module path renamed by
    ``module_name``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables_np["params"]):
        mod, leaf = path.rsplit("/", 1)
        name = module_name(mod)
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
        name = module_name(mod)
        stat = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{name}.{stat}"] = torch.from_numpy(arr.copy())
        sd.setdefault(f"{name}.num_batches_tracked", torch.tensor(0, dtype=torch.long))
    return sd


def jax_to_torch_resnet(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ResNet or CIFAR ResNet ``{'params': ..., 'batch_stats': ...}``
    -> ``state_dict`` for ``nwhead_tpu_torch.models.resnet.ResNet`` or
    ``CIFAR_ResNet``."""
    return _cnn_state_dict(variables_np, _resnet_module)


def jax_to_torch_densenet(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ImageNet ``DenseNet`` tree -> ``state_dict`` for
    ``nwhead_tpu_torch.models.densenet.DenseNet``."""
    return _cnn_state_dict(variables_np, _densenet_module)


def jax_to_torch_cifar_densenet(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CIFAR_DenseNetModule`` tree -> ``state_dict`` for
    ``nwhead_tpu_torch.models.densenet.CIFAR_DenseNetModule``."""
    return _cnn_state_dict(variables_np, _cifar_densenet_module)


def jax_to_torch_featurizer(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any JAX backbone's tree, its family told by its top-level names: a
    ViT (``patch_embed``), an ImageNet DenseNet (``conv0``), the CIFAR
    DenseNet (``bn_final``) or a ResNet."""
    params = variables_np["params"]
    if "patch_embed" in params:
        return jax_to_torch_vit(variables_np)
    if "conv0" in params:
        return jax_to_torch_densenet(variables_np)
    if "bn_final" in params:
        return jax_to_torch_cifar_densenet(variables_np)
    return jax_to_torch_resnet(variables_np)


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


def jax_to_torch_relation(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``RelationNetwork``'s flax tree ``{'params', 'batch_stats'}``
    (``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1``, ``Dense_0``,
    ``Dense_1``; numpy leaves) -> ``state_dict`` for
    ``nwhead_tpu_torch.ops.kernels.RelationNetwork``. The first Dense
    layer's rows are in NHWC order on both sides."""
    params, stats = variables_np["params"], variables_np.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for i in range(2):
        conv = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = torch.from_numpy(np.asarray(conv["bias"]).copy())
        _norm(sd, f"norms.{i}", params[f"BatchNorm_{i}"])
        bn = stats.get(f"BatchNorm_{i}", {})
        for leaf, stat in (("mean", "running_mean"), ("var", "running_var")):
            if leaf in bn:
                sd[f"norms.{i}.{stat}"] = torch.from_numpy(np.asarray(bn[leaf]).copy())
        sd[f"norms.{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    _dense(sd, "fc1", params["Dense_0"])
    _dense(sd, "fc2", params["Dense_1"])
    return sd


def jax_to_torch_nwmodel(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``NWModel`` tree ``{'params': {featurizer, proj?, head?},
    'batch_stats': {featurizer}}`` -> ``state_dict`` for
    ``nwhead_tpu_torch.nw.net.NWModel``, for any featurizer
    (``jax_to_torch_featurizer``); a ViT has no ``batch_stats``."""
    params = variables_np["params"]
    feat = jax_to_torch_featurizer({
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
