"""Headless ResNet / ResNeXt family in PyTorch.

Port of ``nwhead_tpu/models/resnet.py``: ``BasicBlock``, ``Bottleneck``
(with ``groups`` / ``width_per_group``: the ResNeXts), ``ResNet`` with the
7x7/s2 stem or its exact space-to-depth reparameterization (``stem='s2d'``),
the CIFAR-scale pre-activation ``PreActBlock`` / ``CIFAR_ResNet``, and the
constructors of the JAX registry. ``forward`` takes NHWC float images, as
the JAX model does, and returns pooled ``(B, 512 * expansion)`` features.

Conventions kept from the JAX model: torch-style explicit paddings (3 for the
7x7 stem, 1 for 3x3 convs), BatchNorm eps 1e-5, the 3x3/s2/p1 max-pool, the
global average pool taken in f32 (the CIFAR model's 4x4 average pool too,
its output flattened in NHWC order), Kaiming-normal fan-out conv init and
BN weight 1 / bias 0 (0 for each residual branch's last BN with
``zero_init_residual``), and BatchNorm running statistics updated in train
mode as flax updates them (``BatchNorm2d`` below). Submodule names follow
torchvision (``layer1.0.conv3``, ``layer1.0.downsample.0``; the CIFAR
block's ``shortcut.0``, as in the reference's CIFAR ResNet), so torchvision
state dicts load as they are.

``dtype=torch.bfloat16`` is flax's mixed precision (``dtype=jnp.bfloat16``):
parameters and running statistics stay f32; each conv takes its input and
kernel in bf16 and gives bf16 (``Conv2d``); BatchNorm computes its batch
statistics in f32 from the bf16 input as E[x^2] - E[x]^2 and normalizes in
f32, giving bf16 (``BatchNorm2d``, flax 0.12's ``_compute_stats`` and
``_normalize``); the final pool runs in f32.

Sync BatchNorm, flax's ``BatchNorm(axis_name=...)`` (the JAX models'
``bn_axis_name``): when data-parallel replicas of a model run in lockstep
threads (``parallel/data_parallel.py``, one ``ReplicaGroup``), a train-mode
``BatchNorm2d`` whose ``axis_name`` is the group's (or every one, with the
group's ``sync_all``) adds each replica's per-channel (count, sum x, sum
x^2) across the replicas and normalizes every replica by the global E[x]
and E[x^2] - E[x]^2, in f32 for either dtype. The cross-replica sums are
``.to(device)`` and ``+``, so autograd carries the backward reduction; no
barrier waits in a backward. The first replica updates the running
statistics once, from the global mean and biased variance.
"""

from __future__ import annotations

import contextlib
import threading
from functools import reduce
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Inside this context every train-mode ``BatchNorm2d`` of ``module``
    normalizes by the batch statistics as always but leaves its running
    statistics alone: the recompute context of a checkpointed layer, so
    that a step updates them once, as JAX's remat does."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.stats_frozen = False


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _MixedBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of a low-precision input as flax computes it with
    ``dtype``: the statistics in f32 as E[x^2] - E[x]^2 (clamped at 0), then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast to
    ``out_dtype``. Saves only the input (in its own dtype) for the backward,
    which recomputes the normalized input in f32. Returns the output and the
    batch mean and (biased) variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, out_dtype):
        x32 = x.float()
        dims = (0, 2, 3)
        mean = x32.mean(dims)
        var = torch.clamp_min(x32.square().mean(dims) - mean.square(), 0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x32 - _channel(mean)) * _channel(invstd * weight) + _channel(bias)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, grad, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        g = grad.float()
        xhat = (x.float() - _channel(mean)) * _channel(invstd)
        sum_g = g.sum(dims)
        sum_gx = (g * xhat).sum(dims)
        dx = _channel(weight * invstd) * (g - _channel(sum_g / n) - xhat * _channel(sum_gx / n))
        return dx.to(x.dtype), sum_gx, sum_g, None, None


class ReplicaGroup:
    """The data-parallel replicas of one forward, one thread each, that
    sync BatchNorm statistics over: ``n`` replicas, the ``axis_name`` their
    BatchNorms must carry to sync (every train-mode ``BatchNorm2d`` with
    ``sync_all``; the others keep per-replica statistics). ``all_sum`` is the
    lockstep: each replica posts its tensors, waits for the others, and
    gets the sums in replica order on its own device."""

    def __init__(self, n: int, axis_name: Optional[str] = "data", sync_all: bool = False) -> None:
        self.n, self.axis_name, self.sync_all = n, axis_name, sync_all
        self._barrier = threading.Barrier(n)
        self._slots: List = [None] * n

    def syncs(self, bn: "BatchNorm2d") -> bool:
        return self.sync_all or (bn.axis_name is not None and bn.axis_name == self.axis_name)

    def all_sum(self, rank: int, tensors: Sequence[torch.Tensor],
                device: torch.device) -> List[torch.Tensor]:
        self._slots[rank] = tuple(tensors)
        self._barrier.wait()
        posted = list(self._slots)
        self._barrier.wait()  # every replica has read the slots before the next layer writes
        return [reduce(torch.add, (p[i].to(device) for p in posted)) for i in range(len(tensors))]

    def abort(self) -> None:
        """Release the replicas waiting in ``all_sum`` (with
        ``threading.BrokenBarrierError``): one replica failed."""
        self._barrier.abort()


_replica = threading.local()


@contextlib.contextmanager
def replica_context(group: ReplicaGroup, rank: int):
    """This thread runs replica ``rank`` of ``group``."""
    _replica.ctx = (group, rank)
    try:
        yield
    finally:
        _replica.ctx = None


def _replica_ctx():
    return getattr(_replica, "ctx", None)


class _LocalMoments(torch.autograd.Function):
    """Per-channel sums of x and x^2 over (N, H, W), in f32 whatever x's
    dtype; saves only x."""

    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x)
        return x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3))

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        return (_channel(g1) + 2.0 * x.float() * _channel(g2)).to(x.dtype)


class _Normalize(torch.autograd.Function):
    """``(x - mean) * mul + bias`` per channel in f32, cast to ``out_dtype``
    (flax's ``_normalize``); saves x, mean and mul."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias, out_dtype):
        ctx.save_for_backward(x, mean, mul)
        return ((x.float() - _channel(mean)) * _channel(mul) + _channel(bias)).to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, mean, mul = ctx.saved_tensors
        dims = (0, 2, 3)
        g = grad.float()
        gm = g * _channel(mul)
        dmul = (g * (x.float() - _channel(mean))).sum(dims)
        return gm.to(x.dtype), -gm.sum(dims), dmul, g.sum(dims), None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates ``running_var`` with the
    biased batch variance, as flax's ``BatchNorm`` does (torch's own update
    uses the unbiased one; the normalized output is the same). In train
    mode it normalizes by the batch statistics through ``F.batch_norm``
    without running statistics, then updates them from ``torch.var_mean``
    outside autograd (not while ``stats_frozen``, which
    ``frozen_running_stats`` sets). Momentum 0.1 is flax's 0.9.

    ``dtype`` (None or ``torch.bfloat16``, set by ``set_compute_dtype``) is
    flax's compute dtype: the statistics and the affine in f32
    (``_MixedBatchNorm`` in train mode), the result in ``dtype``.

    ``axis_name`` (None, or set by ``set_bn_axis_name``) is flax's: under a
    ``ReplicaGroup`` of that axis, train mode syncs the statistics across
    the replicas (``_sync_forward``); outside one it changes nothing. Under
    a group that does not sync it, each replica normalizes by its own
    statistics and only the first updates the running statistics."""

    dtype: Optional[torch.dtype] = None
    axis_name: Optional[str] = None
    stats_frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = self.training and self.track_running_stats
        update = not self.stats_frozen
        ctx = _replica_ctx() if train else None
        if ctx is not None:
            group, rank = ctx
            if group.syncs(self):
                return self._sync_forward(x, group, rank)
            update = update and rank == 0
        if self.dtype is None:
            if not train:
                return super().forward(x)
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            if update:
                with torch.no_grad():
                    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                    self._update(mean, var)
            return out
        if not train:
            invstd = torch.rsqrt(self.running_var + self.eps)
            y = (x.float() - _channel(self.running_mean)) * _channel(invstd * self.weight)
            return (y + _channel(self.bias)).to(self.dtype)
        out, mean, var = _MixedBatchNorm.apply(x, self.weight, self.bias, self.eps, self.dtype)
        if update:
            with torch.no_grad():
                self._update(mean, var)
        return out

    def _sync_forward(self, x: torch.Tensor, group: ReplicaGroup, rank: int) -> torch.Tensor:
        """Train mode over the replicas' joint batch: the global statistics
        from every replica's (count, sum x, sum x^2), each replica's x
        normalized by them, the running statistics updated once."""
        s1, s2 = _LocalMoments.apply(x)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32, device=x.device)
        n, s1, s2 = group.all_sum(rank, (count, s1, s2), x.device)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = _Normalize.apply(x, mean, mul, self.bias, self.dtype or x.dtype)
        if rank == 0:
            with torch.no_grad():
                self._update(mean.detach(), var.detach())
        return out

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running statistics' step, on the model's own BatchNorm when
        this one is a data-parallel replica on another device
        (``parallel.data_parallel.replicate`` sets ``_master``)."""
        bn = self.__dict__.get("_master", self)
        dev = bn.running_mean.device
        bn.running_mean.lerp_(mean.to(dev), bn.momentum)
        bn.running_var.lerp_(var.to(dev), bn.momentum)
        bn.num_batches_tracked.add_(1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``Conv(dtype=...)``: with ``dtype`` set (by
    ``set_compute_dtype``) the input and kernel are cast to it and the
    result is in it; the parameters stay f32."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), bias)


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Every ``Conv2d`` and ``BatchNorm2d`` of ``model`` computes in
    ``dtype`` (None: f32)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, BatchNorm2d)):
            m.dtype = dtype


def set_bn_axis_name(model: nn.Module, axis_name: Optional[str]) -> None:
    """Every ``BatchNorm2d`` of ``model`` syncs its train-mode statistics
    over the replicas of ``axis_name`` (the JAX models' ``bn_axis_name``;
    None: per-replica statistics)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.axis_name = axis_name


@torch.no_grad()
def init_cnn(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Kaiming-normal (fan_out, relu) convs; BN weight 1, bias 0."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                    generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def conv3x3(in_planes: int, planes: int, stride: int = 1, groups: int = 1) -> Conv2d:
    return Conv2d(in_planes, planes, 3, stride=stride, padding=1, groups=groups, bias=False)


def conv1x1(in_planes: int, planes: int, stride: int = 1) -> Conv2d:
    return Conv2d(in_planes, planes, 1, stride=stride, bias=False)


def _downsample(in_planes: int, out_planes: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(conv1x1(in_planes, out_planes, stride), BatchNorm2d(out_planes, eps=1e-5))


class BasicBlock(nn.Module):
    """Post-activation basic block."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64) -> None:
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64")
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = _downsample(in_planes, planes * self.expansion, stride)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """Post-activation bottleneck block; ``groups`` and ``base_width`` give
    the ResNeXt widths (the 3x3 conv is grouped)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64) -> None:
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv1x1(in_planes, width)
        self.bn1 = BatchNorm2d(width, eps=1e-5)
        self.conv2 = conv3x3(width, width, stride, groups)
        self.bn2 = BatchNorm2d(width, eps=1e-5)
        self.conv3 = conv1x1(width, planes * self.expansion)
        self.bn3 = BatchNorm2d(planes * self.expansion, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(in_planes, planes * self.expansion, stride)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class PreActBlock(nn.Module):
    """Pre-activation basic block of the CIFAR ResNets: the shortcut conv
    (when the shape changes) takes the activated input."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, eps=1e-5)
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = conv3x3(planes, planes)
        self.shortcut = None
        if stride != 1 or in_planes != planes * self.expansion:
            self.shortcut = nn.Sequential(conv1x1(in_planes, planes * self.expansion, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(x))
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = self.conv2(F.relu(self.bn2(self.conv1(out))))
        return out + shortcut


def _stages(block, in_planes: int, layers: Sequence[int], **block_kw):
    """The four stages (64, 128, 256, 512 planes; stride 2 from the second)."""
    stages = []
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if stage == 0 else 2
        mods = []
        for i in range(blocks):
            mods.append(block(in_planes, planes, stride if i == 0 else 1, **block_kw))
            in_planes = planes * block.expansion
        stages.append(nn.Sequential(*mods))
    return stages


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``(B, H, W, C)`` -> ``(B, H/2, W/2, 4C)``, channel index
    ``(dy, dx, c)``, as the JAX model's ``s2d`` stem reshapes."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"the s2d stem needs even H, W, got {H}x{W}")
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """A ``(O, C, 7, 7)`` stride-2 stem kernel -> the equivalent
    ``(O, 4C, 4, 4)`` kernel of the space-to-depth stem (a 4x4 stride-1 conv
    padded (2, 1)): ``w4[:, (dy, dx, c), a + 2, b + 2] = w7[:, c, 2a + dy + 3,
    2b + dx + 3]`` where that tap lies in the 7x7 window, else 0 (the JAX
    package's ``s2d_stem_kernel``, in OIHW)."""
    O, C = w7.shape[:2]
    w4 = w7.new_zeros((O, 4 * C, 4, 4))
    for a in range(-2, 2):
        for dy in range(2):
            u = 2 * a + dy + 3
            if not 0 <= u <= 6:
                continue
            for b in range(-2, 2):
                for dx in range(2):
                    v = 2 * b + dx + 3
                    if not 0 <= v <= 6:
                        continue
                    ch = (dy * 2 + dx) * C
                    w4[:, ch:ch + C, a + 2, b + 2] = w7[:, :, u, v]
    return w4


STEMS = ("conv7", "s2d")


class ResNet(nn.Module):
    """ImageNet-style headless ResNet: NHWC images -> ``(B, 512 * expansion)``
    features at the global average pool."""

    def __init__(
        self,
        block=BasicBlock,
        layers: Sequence[int] = (2, 2, 2, 2),
        *,
        groups: int = 1,
        width_per_group: int = 64,
        zero_init_residual: bool = False,
        dtype: Optional[torch.dtype] = None,
        stem: str = "conv7",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem={stem!r}: use one of {STEMS}")
        self.block, self.stem, self.dtype = block, stem, dtype
        if stem == "s2d":
            self.conv1 = Conv2d(12, 64, 4, bias=False)
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        block_kw = {"groups": groups, "base_width": width_per_group}
        self.layer1, self.layer2, self.layer3, self.layer4 = _stages(block, 64, layers, **block_kw)
        init_cnn(self, generator)
        if zero_init_residual:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, (BasicBlock, Bottleneck)):
                        m.last_bn.weight.zero_()
        set_compute_dtype(self, dtype)

    @property
    def feat_dim(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem == "s2d":
            x = F.pad(space_to_depth(x).permute(0, 3, 1, 2), (2, 1, 2, 1))
        else:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view; cuDNN takes the strides)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return torch.mean(x.to(torch.float32), dim=(2, 3))


def nhwc_pool4(x: torch.Tensor) -> torch.Tensor:
    """The CIFAR models' 4x4/s4 average pool in f32, flattened in NHWC order
    as the JAX model reshapes it (``(B, C)`` at 32 px)."""
    x = F.avg_pool2d(x.to(torch.float32), 4, 4)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CIFAR_ResNet(nn.Module):
    """CIFAR-scale pre-activation ResNet: 3x3 stem, no max-pool, PreAct
    blocks, the 4x4 average pool in f32. ``(B, 512)`` for 32x32 input."""

    def __init__(self, block=PreActBlock, num_blocks: Sequence[int] = (2, 2, 2, 2), *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.block, self.dtype = block, dtype
        self.conv1 = conv3x3(3, 64)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.layer1, self.layer2, self.layer3, self.layer4 = _stages(block, 64, num_blocks)
        init_cnn(self, generator)
        set_compute_dtype(self, dtype)

    @property
    def feat_dim(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return nhwc_pool4(x)


def resnet10(**kw) -> ResNet:
    return ResNet(BasicBlock, (1, 1, 1, 1), **kw)


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)


def resnext50_32x4d(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), groups=32, width_per_group=4, **kw)


def resnext101_32x8d(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), groups=32, width_per_group=8, **kw)


def CIFAR_ResNet10(**kw) -> CIFAR_ResNet:
    return CIFAR_ResNet(PreActBlock, (1, 1, 1, 1), **kw)


def CIFAR_ResNet18(**kw) -> CIFAR_ResNet:
    return CIFAR_ResNet(PreActBlock, (2, 2, 2, 2), **kw)


def CIFAR_ResNet34(**kw) -> CIFAR_ResNet:
    return CIFAR_ResNet(PreActBlock, (3, 4, 6, 3), **kw)
