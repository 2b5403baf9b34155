"""The Nadaraya-Watson head op, fully materialized (the naive ground truth).

Port of ``nwhead_tpu/ops/nw.py``::

    scores = kernel(q[:, None, :], s)      # 2-D support broadcasts to batch
    probs  = softmax(scores, dim=-1) @ one_hot(sy)
    return log(probs + 1e-12)

``support_mask`` (False = padding) sets masked scores to -inf. ``qfeat`` may
be ``(B, D)`` or ``(B, Nq, D)``. The fused serving path
(``nwhead_tpu_torch.ops.fused_nw``) computes the same function with an
online softmax.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from nwhead_tpu_torch.ops.kernels import KernelFn, get_kernel

LOG_FLOOR = 1e-12


def _resolve_kernel(
    kernel: Union[str, KernelFn], kernel_params: Optional[Dict[str, Any]]
) -> Tuple[KernelFn, Dict[str, Any]]:
    if isinstance(kernel, str):
        fn, init_params = get_kernel(kernel)
        return fn, (kernel_params if kernel_params is not None else init_params)
    return kernel, (kernel_params or {})


def _one_hot_labels(sy: torch.Tensor, n_classes: int) -> torch.Tensor:
    """One-hot encode integer labels; pass already-one-hot floats through."""
    if sy.is_floating_point():
        return sy
    return F.one_hot(sy.long(), n_classes).to(torch.float32)


def _broadcast_support(qfeat, sfeat, sy_onehot):
    """Normalize shapes to q:(B,Nq,D), s:(B,S,D), sy:(B,S,C)."""
    if qfeat.dim() == 2:
        qfeat = qfeat[:, None, :]
    batch = qfeat.shape[0]
    if sfeat.dim() == 2:
        sfeat = sfeat[None].expand(batch, *sfeat.shape)
    if sy_onehot.dim() == 2:
        sy_onehot = sy_onehot[None].expand(batch, *sy_onehot.shape)
    return qfeat, sfeat, sy_onehot


def _apply_mask(scores: torch.Tensor, support_mask: Optional[torch.Tensor]):
    if support_mask is None:
        return scores
    mask = support_mask.bool()
    if mask.dim() == 1:
        mask = mask[None, :]
    return scores.masked_fill(~mask[:, None, :], float("-inf"))


def nw_scores(
    qfeat: torch.Tensor,
    sfeat: torch.Tensor,
    *,
    kernel: Union[str, KernelFn] = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    support_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw similarity scores ``(B, Nq, S)``."""
    kernel_fn, kparams = _resolve_kernel(kernel, kernel_params)
    if qfeat.dim() == 2:
        qfeat = qfeat[:, None, :]
    if sfeat.dim() == 2:
        sfeat = sfeat[None].expand(qfeat.shape[0], *sfeat.shape)
    return _apply_mask(kernel_fn(kparams, qfeat, sfeat), support_mask)


def nw_probs_and_weights(
    qfeat: torch.Tensor,
    sfeat: torch.Tensor,
    sy: torch.Tensor,
    n_classes: int,
    *,
    kernel: Union[str, KernelFn] = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    support_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class probabilities and per-support softmax weights:
    ``(probs (B, C), weights (B, S))`` for 2-D queries."""
    squeeze = qfeat.dim() == 2
    q, s, syo = _broadcast_support(qfeat, sfeat, _one_hot_labels(sy, n_classes))
    kernel_fn, kparams = _resolve_kernel(kernel, kernel_params)
    scores = _apply_mask(kernel_fn(kparams, q, s), support_mask)
    weights = torch.softmax(scores, dim=-1)
    probs = torch.matmul(weights, syo)
    if squeeze:
        return probs[:, 0, :], weights[:, 0, :]
    return probs, weights


def nw_log_probs(
    qfeat: torch.Tensor,
    sfeat: torch.Tensor,
    sy: torch.Tensor,
    n_classes: int,
    *,
    kernel: Union[str, KernelFn] = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    support_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``log(probs + 1e-12)``.

    qfeat: (B, D) or (B, Nq, D) query features.
    sfeat: (S, D) shared support or (B, S, D) per-query support.
    sy:    integer labels (S,)/(B, S) or one-hot floats (S, C)/(B, S, C).
    """
    probs, _ = nw_probs_and_weights(
        qfeat, sfeat, sy, n_classes,
        kernel=kernel, kernel_params=kernel_params, support_mask=support_mask,
    )
    return torch.log(probs + LOG_FLOOR)
