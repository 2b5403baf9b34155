"""Similarity kernels for the Nadaraya-Watson head.

Port of ``nwhead_tpu/ops/kernels.py``. Each kernel maps
``(..., num_x, d) x (..., num_y, d) -> (..., num_x, num_y)`` similarity
scores; distance kernels use a *negative* distance so that a larger score
means more similar. Kernels are functions of ``(params, x, y)``; only
``clip`` has a parameter, a scalar ``logit_scale`` initialized to
``log(1/0.07)``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

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
