"""The NW head as an ``nn.Module``.

Port of ``nwhead_tpu/nw/head.py``. The head is the op from
``nwhead_tpu_torch.ops``; the module holds clip's learnable ``logit_scale``
and gives the network one place to choose between the naive op, the fused
raw-feature path (kernels K1/K3, differentiable: the training forward) and
the fused serving path over a prepared bank (K2, K4 or K5 by the bank's
precision, ``from_prepared``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nwhead_tpu_torch.ops import nw as nw_ops
from nwhead_tpu_torch.ops.fused_nw import (
    PreparedSupport, nw_fused_from_prepared, nw_fused_log_probs,
)
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES


class NWHead(nn.Module):
    """``precision`` is ``'f32'``, ``'bf16'``, ``'int8'`` or ``'int4'``: a
    bf16 head rounds the features to bf16 before the distance, on every
    path; int8 and int4 quantize the prepared serving bank (K4, K5,
    ``from_prepared``) and run at f32 on raw features, in training too, as
    the JAX head does. With ``use_fused``,
    a 2-D query against a 2-D support of at least ``fused_min_support`` rows
    takes the fused kernels; anything else the naive op."""

    def __init__(self, n_classes: int, kernel_type: str = "euclidean",
                 precision: str = "f32", use_fused: bool = True,
                 fused_min_support: int = 1024) -> None:
        super().__init__()
        self.n_classes = n_classes
        self.kernel_type = kernel_type
        self.precision = precision
        self.use_fused = use_fused
        self.fused_min_support = fused_min_support
        if kernel_type == "clip":
            self.logit_scale = nn.Parameter(
                torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32)
            )

    def kernel_params(self) -> dict:
        if self.kernel_type == "clip":
            return {"logit_scale": self.logit_scale}
        return {}

    def takes_fused(self, qfeat: torch.Tensor, sfeat: torch.Tensor) -> bool:
        """Whether ``forward`` dispatches these shapes to the fused kernels."""
        return (self.use_fused and sfeat.shape[-2] >= self.fused_min_support
                and sfeat.dim() == 2 and qfeat.dim() == 2
                and self.kernel_type in KERNEL_NAMES)

    def forward(
        self,
        qfeat: torch.Tensor,
        sfeat: torch.Tensor,
        sy: torch.Tensor,
        support_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``log(probs + 1e-12)``, shape ``(B, n_classes)``."""
        if self.takes_fused(qfeat, sfeat):
            return nw_fused_log_probs(
                qfeat, sfeat, sy, self.n_classes, kernel=self.kernel_type,
                kernel_params=self.kernel_params(), support_mask=support_mask,
                precision=self.precision,
            )
        if self.precision == "bf16":
            qfeat = qfeat.to(torch.bfloat16).to(torch.float32)
            sfeat = sfeat.to(torch.bfloat16).to(torch.float32)
        return nw_ops.nw_log_probs(
            qfeat, sfeat, sy, self.n_classes, kernel=self.kernel_type,
            kernel_params=self.kernel_params(), support_mask=support_mask,
        )

    def from_prepared(self, qfeat: torch.Tensor, prepared: PreparedSupport) -> torch.Tensor:
        """Fused serving head over a ``prepare_support`` bank (inference)."""
        return nw_fused_from_prepared(
            qfeat, prepared, self.n_classes, kernel=self.kernel_type,
            kernel_params=self.kernel_params(),
        )
