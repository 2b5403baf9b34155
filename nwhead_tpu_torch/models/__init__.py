"""Backbone registry: name -> headless backbone returning pooled features.

Port of ``nwhead_tpu/models/__init__.py`` for the slices ported so far:
``resnet10`` and ``resnet18``; the ViTs ``vit_s14`` (and its reference name
``dinov2_vits14``), ``vit_b14``, ``vit_l14`` and ``vit_s16``. The other JAX
backbones (deeper ResNets, ResNeXt, the CIFAR variants, DenseNet) are later
slices (ROADMAP.md queue 1, items 7 and 8).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from nwhead_tpu_torch.models import resnet as _resnet
from nwhead_tpu_torch.models import vit as _vit

_REGISTRY = {
    "resnet10": _resnet.resnet10,
    "resnet18": _resnet.resnet18,
    "vit_s14": _vit.vit_s14,  # the reference's dinov2_vits14 architecture (feature width 384)
    "dinov2_vits14": _vit.vit_s14,
    "vit_b14": _vit.vit_b14,
    "vit_l14": _vit.vit_l14,
    "vit_s16": _vit.vit_s16,
}

MODEL_NAMES = tuple(_REGISTRY)
VIT_NAMES = tuple(n for n, f in _REGISTRY.items() if f.__module__ == _vit.__name__)
# What a ViT takes beyond the generator; the ResNets take none of it.
_VIT_OPTIONS = ("attn_impl", "mlp_impl", "dtype", "layerscale_init")


def load_model(
    name: str,
    *,
    device: Union[str, torch.device],
    generator: Optional[torch.Generator] = None,
    **kwargs: Any,
) -> nn.Module:
    """Build a backbone by name, initialized on the CPU from ``generator``
    (so a seed gives the same weights on every device), moved to
    ``device`` and put in eval mode. A ViT also takes ``attn_impl`` and
    ``mlp_impl`` (``'xla'`` or ``'fused'``), ``dtype`` (None or
    ``torch.bfloat16``) and ``layerscale_init``."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ported: {MODEL_NAMES}; "
            "the rest are ROADMAP.md queue 1, item 7)"
        )
    unknown = set(kwargs) - set(_VIT_OPTIONS if name in VIT_NAMES else ())
    if unknown:
        raise ValueError(f"backbone {name!r} takes no {sorted(unknown)}")
    return _REGISTRY[name](generator=generator, **kwargs).to(device).eval()
