"""Headless DenseNet-BC family in PyTorch.

Port of ``nwhead_tpu/models/densenet.py``: ``DenseLayer``, ``DenseBlock``,
``Transition``, the ImageNet ``DenseNet`` (features -> ReLU -> global
average pool in f32) and the CIFAR-scale ``CIFAR_DenseNetModule`` (3x3 stem,
the 4x4 average pool in f32, flattened in NHWC order), with the constructors
``densenet121/161/169/201`` and ``CIFAR_DenseNet121``. ``forward`` takes
NHWC float images and returns ``(B, feat_dim)``.

The two concatenate in opposite orders, as in JAX: the ImageNet block
appends each layer's features (``[features, new]``), the CIFAR block puts
them first (``[new, x]``).

Submodule names: the ImageNet model's are torchvision's
(``features.denseblock1.denselayer1.norm1``, ``features.transition1.conv``,
``features.norm5``), so torchvision state dicts load as they are; the CIFAR
model's are the reference CIFAR DenseNet's (``dense1.0.bn1``,
``trans1.conv``, ``bn``).

``memory_efficient=True`` checkpoints each whole dense layer
(``torch.utils.checkpoint``, non-reentrant), as JAX's ``nn.checkpoint``
remats it: the backward recomputes the layer. Each layer concatenates its
inputs itself (``[features, new]`` in the same order), so a checkpointed
layer keeps the block's pieces, not a concatenation of its own: the
saved activations grow with the layers, not with their square. The
recompute runs inside
``frozen_running_stats``, so a train step updates each BatchNorm's running
statistics once, as JAX does (torchvision's ``memory_efficient`` updates
them twice). ``drop_rate`` drops a dense layer's new features in train mode
with a mask drawn from the layer's own ``torch.Generator`` (before the
checkpoint, so the recompute sees the same mask); JAX's dropout bits come
from ``jax.random`` and are not matched. ``dtype=torch.bfloat16`` computes
as the ResNets do (``models/resnet.py``).
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from nwhead_tpu_torch.models.resnet import (
    BatchNorm2d, Conv2d, frozen_running_stats, init_cnn, nhwc_pool4, set_compute_dtype,
)


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1 -> BN-ReLU-Conv3x3 bottleneck: ``growth_rate`` new
    feature maps."""

    def __init__(self, num_input_features: int, growth_rate: int, bn_size: int = 4,
                 drop_rate: float = 0.0, memory_efficient: bool = False, seed: int = 0) -> None:
        super().__init__()
        self.norm1 = BatchNorm2d(num_input_features, eps=1e-5)
        self.conv1 = Conv2d(num_input_features, bn_size * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2d(bn_size * growth_rate, eps=1e-5)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)
        self.growth_rate, self.drop_rate = growth_rate, float(drop_rate)
        self.memory_efficient = memory_efficient
        self.generator = torch.Generator().manual_seed(seed) if drop_rate > 0 else None

    def _layer(self, keep: Optional[torch.Tensor], *inputs: torch.Tensor) -> torch.Tensor:
        out = self.conv1(F.relu(self.norm1(torch.cat(inputs, 1))))
        out = self.conv2(F.relu(self.norm2(out)))
        return out if keep is None else out * keep

    def _keep_mask(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """flax's ``Dropout`` in train mode: keep with probability 1 - rate,
        scaled by its inverse."""
        if not (self.training and self.drop_rate > 0):
            return None
        B, _, H, W = x.shape
        keep_prob = 1.0 - self.drop_rate
        keep = torch.rand((B, self.growth_rate, H, W), generator=self.generator) < keep_prob
        return (keep.to(torch.float32) / keep_prob).to(device=x.device,
                                                       dtype=self.conv2.dtype or x.dtype)

    def _recompute_context(self):
        """``checkpoint``'s ``context_fn``: nothing around the forward, this
        layer's running statistics frozen around the recompute."""
        return contextlib.nullcontext(), frozen_running_stats(self)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The new features of the concatenation of ``inputs`` (the block's
        input and every earlier layer's features, concatenated here, so
        that a checkpointed layer keeps only the pieces for its
        recompute)."""
        keep = self._keep_mask(inputs[0])
        if self.memory_efficient and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._layer, keep, *inputs, use_reentrant=False,
                context_fn=self._recompute_context)
        return self._layer(keep, *inputs)


class DenseBlock(nn.Module):
    """``num_layers`` dense layers, each fed the concatenation of the block's
    input and every earlier layer's features."""

    def __init__(self, num_layers: int, num_input_features: int, growth_rate: int,
                 bn_size: int = 4, drop_rate: float = 0.0, memory_efficient: bool = False,
                 seed: int = 0) -> None:
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                num_input_features + i * growth_rate, growth_rate, bn_size, drop_rate,
                memory_efficient, seed=seed + i))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = [x]
        for layer in self.children():
            features.append(layer(features))
        return torch.cat(features, 1)


class Transition(nn.Module):
    """BN-ReLU-Conv1x1-AvgPool2 between dense blocks."""

    def __init__(self, num_input_features: int, num_output_features: int) -> None:
        super().__init__()
        self.norm = BatchNorm2d(num_input_features, eps=1e-5)
        self.conv = Conv2d(num_input_features, num_output_features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """Headless ImageNet DenseNet-BC: NHWC images -> ``(B, feat_dim)``."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, *, drop_rate: float = 0.0,
                 memory_efficient: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        mods = OrderedDict([
            ("conv0", Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False)),
            ("norm0", BatchNorm2d(num_init_features, eps=1e-5)),
            ("relu0", nn.ReLU(inplace=True)),
            ("pool0", nn.MaxPool2d(3, stride=2, padding=1)),
        ])
        n = num_init_features
        for i, num_layers in enumerate(block_config):
            mods[f"denseblock{i + 1}"] = DenseBlock(
                num_layers, n, growth_rate, bn_size, drop_rate, memory_efficient,
                seed=1000 * (i + 1))
            n += num_layers * growth_rate
            if i != len(block_config) - 1:
                mods[f"transition{i + 1}"] = Transition(n, n // 2)
                n //= 2
        mods["norm5"] = BatchNorm2d(n, eps=1e-5)
        self.features = nn.Sequential(mods)
        self._feat_dim = n
        init_cnn(self, generator)
        set_compute_dtype(self, dtype)

    @property
    def feat_dim(self) -> int:
        return self._feat_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.features(x.permute(0, 3, 1, 2)))
        return torch.mean(x.to(torch.float32), dim=(2, 3))


class _CIFARDenseLayer(nn.Module):
    """The CIFAR DenseNet's pre-activation bottleneck: BN-ReLU-Conv1x1(4g)
    -> BN-ReLU-Conv3x3(g)."""

    def __init__(self, in_planes: int, growth_rate: int) -> None:
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, eps=1e-5)
        self.conv1 = Conv2d(in_planes, 4 * growth_rate, 1, bias=False)
        self.bn2 = BatchNorm2d(4 * growth_rate, eps=1e-5)
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([h, x], 1)  # the new features first


class _CIFARTransition(nn.Module):
    def __init__(self, in_planes: int, out_planes: int) -> None:
        super().__init__()
        self.bn = BatchNorm2d(in_planes, eps=1e-5)
        self.conv = Conv2d(in_planes, out_planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class CIFAR_DenseNetModule(nn.Module):
    """Headless CIFAR-scale DenseNet-BC: ``(B, feat_dim)`` for 32x32 input."""

    def __init__(self, nblocks: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 12,
                 reduction: float = 0.5, *, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        num_planes = 2 * growth_rate
        self.conv1 = Conv2d(3, num_planes, 3, padding=1, bias=False)
        for i, nb in enumerate(nblocks):
            layers = []
            for _ in range(nb):
                layers.append(_CIFARDenseLayer(num_planes, growth_rate))
                num_planes += growth_rate
            setattr(self, f"dense{i + 1}", nn.Sequential(*layers))
            if i != len(nblocks) - 1:
                out_planes = int(math.floor(num_planes * reduction))
                setattr(self, f"trans{i + 1}", _CIFARTransition(num_planes, out_planes))
                num_planes = out_planes
        self.bn = BatchNorm2d(num_planes, eps=1e-5)
        self.n_blocks, self._feat_dim = len(nblocks), num_planes
        init_cnn(self, generator)
        set_compute_dtype(self, dtype)

    @property
    def feat_dim(self) -> int:
        return self._feat_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            x = getattr(self, f"dense{i + 1}")(x)
            if i != self.n_blocks - 1:
                x = getattr(self, f"trans{i + 1}")(x)
        return nhwc_pool4(F.relu(self.bn(x)))


def densenet121(**kw) -> DenseNet:
    return DenseNet(32, (6, 12, 24, 16), 64, **kw)


def densenet161(**kw) -> DenseNet:
    return DenseNet(48, (6, 12, 36, 24), 96, **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(32, (6, 12, 32, 32), 64, **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(32, (6, 12, 48, 32), 64, **kw)


def CIFAR_DenseNet121(**kw) -> CIFAR_DenseNetModule:
    return CIFAR_DenseNetModule((6, 12, 24, 16), growth_rate=32, **kw)
