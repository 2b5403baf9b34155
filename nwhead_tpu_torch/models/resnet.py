"""Headless ResNet (BasicBlock family) in PyTorch.

Port of ``nwhead_tpu/models/resnet.py``: ``BasicBlock``, ``ResNet`` with the
7x7/s2 stem, ``resnet10`` and ``resnet18``. ``forward`` takes NHWC float
images, as the JAX model does, and returns pooled ``(B, 512)`` features.

Conventions kept from the JAX model: torch-style explicit paddings (3 for the
7x7 stem, 1 for 3x3 convs), BatchNorm eps 1e-5, the 3x3/s2/p1 max-pool, the
global average pool taken in f32, Kaiming-normal fan-out conv init and BN
weight 1 / bias 0, and BatchNorm running statistics updated in train mode
as flax updates them (``BatchNorm2d`` below). Submodule names follow
torchvision (``layer1.0.conv1``, ``layer1.0.downsample.0``), so torchvision
state dicts load as they are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates ``running_var`` with the
    biased batch variance, as flax's ``BatchNorm`` does (torch's own update
    uses the unbiased one; the normalized output is the same). In train
    mode it normalizes by the batch statistics through ``F.batch_norm``
    without running statistics, then updates them from ``torch.var_mean``
    outside autograd. Momentum 0.1 is flax's 0.9."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


def conv3x3(in_planes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)


def conv1x1(in_planes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    """Post-activation basic block."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_planes != planes * self.expansion:
            self.downsample = nn.Sequential(
                conv1x1(in_planes, planes * self.expansion, stride),
                BatchNorm2d(planes * self.expansion, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ImageNet-style headless ResNet: NHWC images -> ``(B, 512 * expansion)``
    features at the global average pool."""

    def __init__(
        self,
        block=BasicBlock,
        layers: Sequence[int] = (2, 2, 2, 2),
        *,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.block = block
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                mods.append(block(in_planes, planes, stride if i == 0 else 1))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
        self.reset_parameters(generator)

    @property
    def feat_dim(self) -> int:
        return 512 * self.block.expansion

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-normal (fan_out, relu) convs; BN weight 1, bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(
                    m.weight, mode="fan_out", nonlinearity="relu", generator=generator
                )
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view; cuDNN takes the strides)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return torch.mean(x.to(torch.float32), dim=(2, 3))


def resnet10(**kw) -> ResNet:
    return ResNet(BasicBlock, (1, 1, 1, 1), **kw)


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)
