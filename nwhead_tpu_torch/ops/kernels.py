"""Similarity kernels for the Nadaraya-Watson head.

Port of ``nwhead_tpu/ops/kernels.py``. Each kernel maps
``(..., num_x, d) x (..., num_y, d) -> (..., num_x, num_y)`` similarity
scores; distance kernels use a *negative* distance so that a larger score
means more similar. Kernels are functions of ``(params, x, y)``; only
``clip`` has a parameter, a scalar ``logit_scale`` initialized to
``log(1/0.07)``. ``RelationNetwork``, a learned conv relation kernel on
feature maps, is defined but not registered, as in the JAX package and the
reference.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

KernelFn = Callable[[Dict[str, Any], torch.Tensor, torch.Tensor], torch.Tensor]

# Matches torch.nn.functional.normalize default eps.
_NORMALIZE_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim`` with the norm clamped at ``1e-12``. The
    norm rounds as XLA computes ``jnp.linalg.norm``: squares and their sum
    in f32, the sum rounded to ``x``'s dtype before the sqrt (which matters
    for bf16 banks only)."""
    xf = x.to(torch.float32)
    sq = torch.sum(xf * xf, dim=dim, keepdim=True).to(x.dtype)
    return x / torch.clamp(torch.sqrt(sq), min=_NORMALIZE_EPS)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances via ``|x|^2 + |y|^2 - 2<x,y>``,
    clamped at 0. x: (..., nx, d), y: (..., ny, d) -> (..., nx, ny)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.matmul(x, y.transpose(-1, -2))
    d2 = x2 - 2.0 * xy + y2.transpose(-1, -2)
    return torch.clamp(d2, min=0.0)


def pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances (``torch.cdist``'s values), with the
    sqrt taken only where ``d2 > 0`` so the gradient at 0 is 0, not NaN."""
    d2 = pairwise_sqdist(x, y)
    pos = d2 > 0.0
    safe = torch.where(pos, d2, torch.ones_like(d2))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))


def euclidean(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    del params
    return -pairwise_dist(x, y)


def hypersphere_euclidean(
    params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    del params
    return -pairwise_dist(_l2_normalize(x), _l2_normalize(y))


def cosine(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    del params
    return torch.matmul(_l2_normalize(x), _l2_normalize(y).transpose(-1, -2))


def dotproduct(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    del params
    return torch.matmul(x, y.transpose(-1, -2))


def clip(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``exp(logit_scale) * cos(x, y)``."""
    return torch.exp(params["logit_scale"]) * cosine({}, x, y)


def _clip_init() -> Dict[str, Any]:
    return {"logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32)}


class RelationNetwork(nn.Module):
    """Learned conv relation kernel (``nwhead_tpu/ops/kernels.py:108``; the reference's
    ``kernel.py:46-78``), not registered in the kernel factory.

    ``score(x, y) = -sigmoid(MLP(conv(|x - y|)))`` on feature maps: two
    blocks of 3x3 conv (64 channels, padding 1), BatchNorm whose running
    statistics are the last batch's (flax momentum 0, torch momentum 1,
    biased variance), ReLU and 2x2 max-pool, then Dense-ReLU-Dense-sigmoid,
    negated. Maps are NHWC, flattened in that order as the JAX module does.
    ``in_ch_size`` is the maps' channel count, ``input_size`` the width the
    first Dense layer takes (``64 * (h // 4) * (w // 4)``). Train or eval
    BatchNorm by the module's mode."""

    def __init__(self, in_ch_size: int, input_size: int, hidden_size: int,
                 symmetric: bool = True) -> None:
        from nwhead_tpu_torch.models.resnet import BatchNorm2d

        super().__init__()
        self.symmetric = symmetric
        self.convs = nn.ModuleList([nn.Conv2d(in_ch_size, 64, 3, padding=1),
                                    nn.Conv2d(64, 64, 3, padding=1)])
        self.norms = nn.ModuleList([BatchNorm2d(64, momentum=1.0) for _ in range(2)])
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, 1)

    def relation(self, d: torch.Tensor) -> torch.Tensor:
        """``sigmoid(MLP(conv(d)))`` of NHWC maps ``d (n, h, w, c)`` -> ``(n, 1)``."""
        d = d.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            d = F.max_pool2d(F.relu(norm(conv(d))), 2)
        d = d.permute(0, 2, 3, 1).reshape(d.shape[0], -1)
        return torch.sigmoid(self.fc2(F.relu(self.fc1(d))))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``x (bs, nq, h, w, c)``, ``y (bs, ns, h, w, c)`` -> ``(bs, nq, ns)``."""
        if not self.symmetric:
            raise ValueError("only the symmetric |x - y| variant is defined")
        bs, nq, ns = x.shape[0], x.shape[1], y.shape[1]
        diff = torch.abs(x[:, :, None] - y[:, None, :, :])
        return -self.relation(diff.reshape(-1, *diff.shape[3:])).reshape(bs, nq, ns)


_KERNELS: Dict[str, Tuple[KernelFn, Callable[[], Dict[str, Any]]]] = {
    "euclidean": (euclidean, dict),
    "hypersphere_euclidean": (hypersphere_euclidean, dict),
    "cosine": (cosine, dict),
    "dotproduct": (dotproduct, dict),
    "clip": (clip, _clip_init),
}

KERNEL_NAMES = tuple(_KERNELS)


def get_kernel(kernel_type: str) -> Tuple[KernelFn, Dict[str, Any]]:
    """Kernel factory: ``(kernel_fn, init_params)``; unknown names raise
    ``NotImplementedError``."""
    if kernel_type not in _KERNELS:
        raise NotImplementedError(
            f"Unknown kernel type {kernel_type!r}; valid: {KERNEL_NAMES}"
        )
    fn, init = _KERNELS[kernel_type]
    return fn, init()
