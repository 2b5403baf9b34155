"""Load local torchvision- and DINOv2-format checkpoints into the port's
backbones.

Port of ``nwhead_tpu/models/torch_import.py``. The port's CNNs keep
torchvision's submodule names, so a torchvision ``state_dict`` needs no key
map here; only the JAX package had to convert it into flax trees. What is
kept:

* ``load_state_dict_file``: ``.pth``/``.pt`` through ``torch.load`` (tensors
  only, ``weights_only=True``), a ``{"state_dict": ...}`` wrapper unwrapped;
  ``.npz`` through numpy;
* the strict=False merge of ``load_pretrained``: keys present in both are
  copied in (shapes asserted), extra keys (``fc.*``, ``classifier.*``,
  ``num_batches_tracked``, anything the model lacks) are ignored, missing
  ones keep their initialization; a 7x7 stem kernel goes into an ``s2d``
  model through ``resnet.s2d_stem_kernel``;
* DenseNet's legacy ``denselayerN.norm.1``-style keys remapped to
  ``norm1`` (the reference's ``_load_state_dict`` pattern);
* the DINOv2 names of a ViT mapped onto the port's: ``patch_embed.proj.*``
  -> ``patch_embed.*``, ``blocks.i.ls1.gamma`` -> ``blocks.i.ls1_gamma``;
  ``mask_token`` and ``head.*`` skipped.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from nwhead_tpu_torch.models.resnet import s2d_stem_kernel

# The reference's legacy DenseNet key pattern (``densenet.py:172-173``).
_DENSE_LEGACY = re.compile(
    r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|running_mean|running_var))$"
)
_IGNORED_PREFIXES = ("fc.", "classifier.")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat ``name -> tensor`` dict: torch ``.pth``/
    ``.pt`` (a ``{"state_dict": ...}`` wrapper unwrapped) or ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def remap_densenet_legacy(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """``...denselayerN.norm.1.weight`` -> ``...denselayerN.norm1.weight``."""
    out = {}
    for key, value in state_dict.items():
        m = _DENSE_LEGACY.match(key)
        out[m.group(1) + m.group(2) if m else key] = value
    return out


def convert_dinov2_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """DINOv2 ViT names -> the port's ``VisionTransformer`` names."""
    out = {}
    for key, value in state_dict.items():
        if key == "mask_token" or key.startswith("head."):
            continue  # the SSL mask token and the classifier: headless
        key = re.sub(r"^patch_embed\.proj\.", "patch_embed.", key)
        key = re.sub(r"^(blocks\.\d+\.ls[12])\.gamma$", r"\1_gamma", key)
        out[key] = value
    return out


def _is_s2d_of(have: torch.Size, want: torch.Size) -> bool:
    """A 7x7 stem kernel offered to a 4x4 space-to-depth stem."""
    return (len(have) == len(want) == 4 and tuple(have[2:]) == (7, 7)
            and tuple(want[2:]) == (4, 4) and want[1] == 4 * have[1])


@torch.no_grad()
def load_pretrained(model: nn.Module, state_dict: Mapping[str, Any]) -> Dict[str, list]:
    """Merge ``state_dict`` into ``model`` in place, strict=False style.
    Returns the keys ``loaded``, the model's keys left ``missing`` and the
    file's keys ``ignored``."""
    from nwhead_tpu_torch.models.densenet import DenseNet
    from nwhead_tpu_torch.models.vit import VisionTransformer

    if isinstance(model, VisionTransformer):
        state_dict = convert_dinov2_state_dict(state_dict)
    elif isinstance(model, DenseNet):
        state_dict = remap_densenet_legacy(state_dict)
    own = model.state_dict()
    loaded, ignored = [], []
    for key, value in state_dict.items():
        if (key.startswith(_IGNORED_PREFIXES) or key.endswith("num_batches_tracked")
                or key not in own):
            ignored.append(key)
            continue
        value = torch.as_tensor(value)
        if value.shape != own[key].shape and _is_s2d_of(value.shape, own[key].shape):
            value = s2d_stem_kernel(value)
        if value.shape != own[key].shape:
            raise ValueError(f"{key}: the file's shape {tuple(value.shape)} is not the "
                             f"model's {tuple(own[key].shape)}")
        own[key].copy_(value.to(own[key].dtype))
        loaded.append(key)
    missing = [k for k in own if k not in set(loaded) and not k.endswith("num_batches_tracked")]
    return {"loaded": loaded, "missing": missing, "ignored": ignored}
