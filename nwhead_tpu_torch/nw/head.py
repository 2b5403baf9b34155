"""The NW head as an ``nn.Module``.

Port of ``nwhead_tpu/nw/head.py``. The head is the op from
``nwhead_tpu_torch.ops``; the module holds clip's learnable ``logit_scale``
and gives the network one place to choose between the naive op
(``forward``) and the fused serving path over a prepared bank
(``from_prepared``). The fused raw-feature path of the training forward
(kernel K1) is a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nwhead_tpu_torch.ops import nw as nw_ops
from nwhead_tpu_torch.ops.fused_nw import PreparedSupport, nw_fused_from_prepared


class NWHead(nn.Module):
    """``precision`` is ``'f32'`` or ``'bf16'``: a bf16 head rounds the
    features to bf16 before the distance, on both paths."""

    def __init__(self, n_classes: int, kernel_type: str = "euclidean",
                 precision: str = "f32") -> None:
        super().__init__()
        self.n_classes = n_classes
        self.kernel_type = kernel_type
        self.precision = precision
        if kernel_type == "clip":
            self.logit_scale = nn.Parameter(
                torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32)
            )

    def kernel_params(self) -> dict:
        if self.kernel_type == "clip":
            return {"logit_scale": self.logit_scale}
        return {}

    def forward(
        self,
        qfeat: torch.Tensor,
        sfeat: torch.Tensor,
        sy: torch.Tensor,
        support_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Naive head: ``log(probs + 1e-12)``, shape ``(B, n_classes)``."""
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
