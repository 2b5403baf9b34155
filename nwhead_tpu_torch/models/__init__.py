"""Backbone registry: name -> headless backbone returning pooled features.

Port of ``nwhead_tpu/models/__init__.py`` for the serving slice: ``resnet10``
and ``resnet18``. The other JAX backbones (deeper ResNets, ResNeXt, the CIFAR
variants, DenseNet, ViT) are later slices (ROADMAP.md queue 1, items 5 and 9).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from nwhead_tpu_torch.models import resnet as _resnet

_REGISTRY = {
    "resnet10": _resnet.resnet10,
    "resnet18": _resnet.resnet18,
}

MODEL_NAMES = tuple(_REGISTRY)


def load_model(
    name: str,
    *,
    device: Union[str, torch.device],
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build a backbone by name, initialized on the CPU from ``generator``
    (so a seed gives the same weights on every device), moved to
    ``device`` and put in eval mode."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ported: {MODEL_NAMES}; "
            "the rest are ROADMAP.md queue 1, items 5 and 9)"
        )
    return _REGISTRY[name](generator=generator).to(device).eval()
