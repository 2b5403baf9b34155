"""Support influence: the closed-form leave-one-out effect of each support
item on a query's loss.

Port of ``nwhead_tpu/ops/influence.py`` (the reference's
``util/metric.py:23-50``)::

    influence_i = log((p - p w_i) / (p - w_i 1[y_i == y_q]))

``p`` the predicted probability of the query's true class, ``w_i`` the
softmax weight on support item ``i``. Positive: removing item ``i`` would
raise the loss, so it helped. One batched expression, any batch size.
"""

from __future__ import annotations

import torch


def support_influence(
    softmaxes: torch.Tensor,
    qlabels,
    sweights: torch.Tensor,
    slabels,
) -> torch.Tensor:
    """Leave-one-out influence ``(B, S)`` of each support item on each query.

    softmaxes: (B, C) class probabilities.
    qlabels:   (B,) int labels or (B, C) one-hot.
    sweights:  (B, S) softmax weights of each query over the support.
    slabels:   (S,) / (B, S) int labels or (S, C) / (B, S, C) one-hot.
    """
    dev = softmaxes.device
    qlabels = torch.as_tensor(qlabels, device=dev)
    slabels = torch.as_tensor(slabels, device=dev)
    qcat = torch.argmax(qlabels, dim=-1) if qlabels.dim() == 2 else qlabels
    scat = torch.argmax(slabels, dim=-1) if slabels.is_floating_point() else slabels
    if scat.dim() == 1:
        scat = scat[None, :]  # a shared support broadcasts over the batch
    qcat = qcat.to(torch.int64)
    p = torch.gather(softmaxes, -1, qcat[:, None])  # (B, 1)
    indicator = (scat.to(torch.int64) == qcat[:, None]).to(sweights.dtype)
    return torch.log((p - p * sweights) / (p - sweights * indicator))
