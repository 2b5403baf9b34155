"""The FC-head baseline: a featurizer and one linear classifier.

Port of ``nwhead_tpu/nw/fc.py``. ``FCNet`` returns log-softmax, so the FC
and NW trainers share the NLL loss. ``FCHead`` is an ``nn.Linear`` named
``fc`` whose weight and bias are drawn from ``generator`` uniform in
±1/sqrt(fan_in), torch's own ``nn.Linear`` default, which the JAX package
copies. A bf16 featurizer's features are widened to f32 for the
classifier, as flax's Dense promotes them against its f32 kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FCHead(nn.Module):
    """Linear classifier ``(B, in_dim) -> (B, out_dim)`` logits."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)
        bound = 1.0 / math.sqrt(in_dim)
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class FCNet(nn.Module):
    """Featurizer (with its ``feat_dim``) + ``FCHead`` -> log-softmax over
    the classes."""

    def __init__(self, featurizer: nn.Module, num_classes: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.featurizer = featurizer
        self.num_classes = num_classes
        self.classifier = FCHead(featurizer.feat_dim, num_classes, generator)

    def extract_feat(self, x: torch.Tensor) -> torch.Tensor:
        return self.featurizer(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.classifier(self.featurizer(x).to(self.classifier.fc.weight.dtype))
        return F.log_softmax(logits, dim=-1)
