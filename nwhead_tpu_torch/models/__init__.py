"""Backbone registry: name -> headless backbone returning pooled features.

Port of ``nwhead_tpu/models/__init__.py``: every name of the JAX registry,
the ResNets and ResNeXts, the CIFAR ResNets, the DenseNets and the ViTs
(``vit_s14``, its reference name ``dinov2_vits14``, ``vit_b14``, ``vit_l14``,
``vit_s16``), ``feature_dim`` and ``load_model(name, pretrained=path)``,
which merges a local torchvision- or DINOv2-format checkpoint into the
fresh model at build time (``models/pretrained.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from nwhead_tpu_torch.models import densenet as _densenet
from nwhead_tpu_torch.models import resnet as _resnet
from nwhead_tpu_torch.models import vit as _vit

_REGISTRY = {
    "resnet10": _resnet.resnet10,
    "resnet18": _resnet.resnet18,
    "resnet34": _resnet.resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
    "resnext50_32x4d": _resnet.resnext50_32x4d,
    "resnext101_32x8d": _resnet.resnext101_32x8d,
    "CIFAR_ResNet10": _resnet.CIFAR_ResNet10,
    "CIFAR_ResNet18": _resnet.CIFAR_ResNet18,
    "CIFAR_ResNet34": _resnet.CIFAR_ResNet34,
    "densenet121": _densenet.densenet121,
    "densenet161": _densenet.densenet161,
    "densenet169": _densenet.densenet169,
    "densenet201": _densenet.densenet201,
    "CIFAR_DenseNet121": _densenet.CIFAR_DenseNet121,
    "vit_s14": _vit.vit_s14,  # the reference's dinov2_vits14 architecture (feature width 384)
    "dinov2_vits14": _vit.vit_s14,
    "vit_b14": _vit.vit_b14,
    "vit_l14": _vit.vit_l14,
    "vit_s16": _vit.vit_s16,
}

MODEL_NAMES = tuple(_REGISTRY)
VIT_NAMES = tuple(n for n, f in _REGISTRY.items() if f.__module__ == _vit.__name__)


def _options(name: str) -> tuple:
    """What a backbone takes beyond the generator, as the JAX module's
    fields: a ViT ``attn_impl``, ``mlp_impl``, ``dtype`` and
    ``layerscale_init``; an ImageNet ResNet ``dtype``, ``zero_init_residual``
    and ``stem``; an ImageNet DenseNet ``dtype``, ``memory_efficient`` and
    ``drop_rate``; the CIFAR models ``dtype``."""
    if name in VIT_NAMES:
        return ("attn_impl", "mlp_impl", "dtype", "layerscale_init")
    if name.startswith("CIFAR_"):
        return ("dtype",)
    if name.startswith("densenet"):
        return ("dtype", "memory_efficient", "drop_rate")
    return ("dtype", "zero_init_residual", "stem")


def _build(name: str, kwargs: dict, generator: Optional[torch.Generator] = None) -> nn.Module:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; valid: {MODEL_NAMES}")
    unknown = set(kwargs) - set(_options(name))
    if unknown:
        raise ValueError(f"backbone {name!r} takes no {sorted(unknown)} "
                         f"(it takes {list(_options(name))})")
    if kwargs.get("dtype") not in (None, torch.bfloat16):
        raise ValueError(f"dtype {kwargs['dtype']}: use None (f32) or torch.bfloat16")
    return _REGISTRY[name](generator=generator, **kwargs)


def load_model(
    name: str,
    *,
    device: Union[str, torch.device],
    generator: Optional[torch.Generator] = None,
    pretrained: Any = False,
    **kwargs: Any,
) -> nn.Module:
    """Build a backbone by name, initialized on the CPU from ``generator``
    (so a seed gives the same weights on every device), moved to
    ``device`` and put in eval mode. ``kwargs`` are the family's options
    (``_options``). ``pretrained`` is False or the path of a local checkpoint
    (``.pth``/``.pt``/``.npz``: a torchvision-named CNN or a DINOv2-named
    ViT state dict), merged strict=False style into the fresh weights before
    the move (``pretrained.load_pretrained``); the module keeps the path as
    ``pretrained_path``. A later checkpoint of the training CLI overrides
    it, as in the JAX package."""
    if pretrained is True:
        raise ValueError(
            "pretrained=True needs a checkpoint path (nothing is downloaded): "
            "load_model(name, pretrained='/path/to/weights.pth')"
        )
    model = _build(name, kwargs, generator)
    model.pretrained_path = None
    if pretrained:
        from nwhead_tpu_torch.models.pretrained import load_pretrained, load_state_dict_file

        load_pretrained(model, load_state_dict_file(str(pretrained)))
        model.pretrained_path = str(pretrained)
    return model.to(device).eval()


def feature_dim(name: str, **kwargs: Any) -> int:
    """Output feature width of a backbone (built on the meta device: no
    weights are drawn)."""
    with torch.device("meta"):
        return _build(name, kwargs).feat_dim
