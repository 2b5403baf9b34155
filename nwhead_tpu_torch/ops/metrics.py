"""Metrics: accuracy, ROC-AUC, 15-bin ECE, NLL losses, running accumulator.

Port of ``nwhead_tpu/ops/metrics.py`` in PyTorch: ``acc``, ``roc`` (the
Mann-Whitney rank form with midranks for ties), ``ece`` (15 equal bins,
membership ``lower < conf <= upper``, empty bins add 0), the NLL variants
and ``Metric``. Array functions take tensors or numpy arrays and return
0-d tensors; ``Metric`` is host bookkeeping.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _t(x, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return t if dtype is None else t.to(dtype)


def acc(pred, targets) -> torch.Tensor:
    """Accuracy of categorical predictions."""
    pred, targets = _t(pred), _t(targets)
    return torch.mean((pred == targets.to(pred.device)).to(torch.float32))


def roc(pr, gt) -> torch.Tensor:
    """100 * ROC-AUC for binary ground truth, by the Mann-Whitney U
    statistic with midranks for tied scores."""
    pr = _t(pr, torch.float32).reshape(-1)
    gt = _t(gt).reshape(-1).to(torch.float32)
    order = torch.argsort(pr)
    sorted_pr = pr[order]
    first = torch.searchsorted(sorted_pr, sorted_pr, right=False).to(torch.float32)
    last = torch.searchsorted(sorted_pr, sorted_pr, right=True).to(torch.float32)
    ranks = torch.zeros_like(pr)
    ranks[order] = (first + last - 1.0) / 2.0 + 1.0
    n = pr.shape[0]
    n_pos = torch.sum(gt)
    n_neg = n - n_pos
    auc = (torch.sum(ranks * gt) - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)
    return 100.0 * auc


def ece(softmaxes, labels, n_bins: int = 15) -> torch.Tensor:
    """Expected calibration error over ``n_bins`` equal confidence bins, in
    [0, 1] (the trainers multiply by 100)."""
    softmaxes, labels = _t(softmaxes), _t(labels)
    confidences, predictions = torch.max(softmaxes, dim=1)
    accuracies = (predictions == labels.to(predictions.device)).to(torch.float32)
    # jnp.linspace's edges, not torch.linspace's (six of 16 f32 edges differ
    # by an ulp, and a confidence on an edge then changes bins): i * f32(1/n)
    # in f32, the last edge exactly 1.
    boundaries = torch.arange(n_bins + 1, dtype=torch.float32) * torch.tensor(
        1.0 / n_bins, dtype=torch.float32)
    boundaries[-1] = 1.0
    boundaries = boundaries.to(softmaxes.device)
    in_bin = ((confidences[None, :] > boundaries[:-1, None])
              & (confidences[None, :] <= boundaries[1:, None])).to(torch.float32)
    counts = torch.sum(in_bin, dim=1)
    prop_in_bin = counts / confidences.shape[0]
    safe = torch.clamp(counts, min=1.0)
    acc_in_bin = torch.sum(in_bin * accuracies[None, :], dim=1) / safe
    conf_in_bin = torch.sum(in_bin * confidences[None, :], dim=1) / safe
    gaps = torch.abs(conf_in_bin - acc_in_bin) * prop_in_bin
    return torch.sum(torch.where(counts > 0, gaps, 0.0))


def nll_loss(log_probs: torch.Tensor, targets) -> torch.Tensor:
    """Mean negative log-likelihood on log-probabilities (torch ``NLLLoss``)."""
    targets = _t(targets).to(device=log_probs.device, dtype=torch.long)
    return -torch.mean(torch.gather(log_probs, -1, targets[:, None]))


def nll_loss_onehot(log_probs: torch.Tensor, targets_onehot: torch.Tensor) -> torch.Tensor:
    """NLL on one-hot targets."""
    return -torch.mean(torch.sum(targets_onehot * log_probs, dim=-1))


def label_smoothing_loss_onehot(log_probs: torch.Tensor, targets_onehot: torch.Tensor,
                                smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothing NLL on one-hot targets."""
    smoothed = targets_onehot * (1.0 - smoothing) + smoothing / log_probs.shape[-1]
    return -torch.mean(torch.sum(smoothed * log_probs, dim=-1))


def smooth_nll_loss(log_probs: torch.Tensor, targets, smoothing: float = 0.0,
                    weight: Optional[torch.Tensor] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Label-smoothing NLL on log-probabilities: ``1 - smoothing`` on the
    target, ``smoothing / (C - 1)`` on every other class."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
    targets = _t(targets).to(device=log_probs.device, dtype=torch.long)
    smoothed = torch.full_like(log_probs, smoothing / (log_probs.shape[-1] - 1))
    smoothed.scatter_(-1, targets[:, None], 1.0 - smoothing)
    if weight is not None:
        log_probs = log_probs * weight[None, :]
    loss = -torch.sum(smoothed * log_probs, dim=-1)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


class Metric:
    """Running weighted mean."""

    def __init__(self) -> None:
        self.tot_val = 0.0
        self.num_samples = 0

    def update_state(self, val, samples: int) -> None:
        self.num_samples += samples
        self.tot_val += float(val) * samples

    def result(self) -> float:
        if self.num_samples == 0:
            return 0
        return self.tot_val / self.num_samples

    def reset_state(self) -> None:
        self.tot_val = 0.0
        self.num_samples = 0
