"""The NW head as an ``nn.Module``.

Port of ``nwhead_tpu/nw/head.py``. The head is the op from
``nwhead_tpu_torch.ops``; the module holds clip's learnable ``logit_scale``
and gives the network one place to choose between the naive op, the fused
raw-feature path (kernels K1/K3, differentiable: the training forward) and
the fused serving path over a prepared bank (K2, K4 or K5 by the bank's
precision, ``from_prepared``). ``probs_and_weights`` and ``scores`` give the
naive op's class probabilities with the per-support softmax weights, and
the raw scores, for support influence and neighbour rankings.

``PreparedHead`` and ``IVFHead`` are the serving heads over one bank as
modules, the bank's tensors and the kernel's parameters held as buffers:
the heads of an exported serving program (``NWNet.serving_module``,
``utils/aot.py``).
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
from nwhead_tpu_torch.ops.ivf import IVFPrepared, nw_fused_ivf_log_probs
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

    def probs_and_weights(self, qfeat: torch.Tensor, sfeat: torch.Tensor, sy: torch.Tensor,
                          support_mask: Optional[torch.Tensor] = None):
        """``(probs (B, C), softmax weights (B, S))`` by the naive op at f32,
        as the JAX head gives them (for ``support_influence``)."""
        return nw_ops.nw_probs_and_weights(
            qfeat, sfeat, sy, self.n_classes, kernel=self.kernel_type,
            kernel_params=self.kernel_params(), support_mask=support_mask,
        )

    def scores(self, qfeat: torch.Tensor, sfeat: torch.Tensor,
               support_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw similarity scores ``(B, 1, S)`` of 2-D queries (the naive op)."""
        return nw_ops.nw_scores(
            qfeat, sfeat, kernel=self.kernel_type, kernel_params=self.kernel_params(),
            support_mask=support_mask,
        )


class PreparedHead(nn.Module):
    """The fused serving head over one prepared bank (K2, K4 or K5 by its
    precision) as a module: the bank's ``s``, ``s2``, ``labels`` and
    ``sscale`` and the kernel's parameters (clip's ``logit_scale``) copied
    into buffers. A snapshot: later edits of the bank do not reach it."""

    def __init__(self, prepared: PreparedSupport, n_classes: int, kernel: str,
                 kernel_params: Optional[dict] = None) -> None:
        super().__init__()
        self.n_classes, self.kernel, self.block_s = n_classes, kernel, prepared.block_s
        for name in ("s", "s2", "labels", "sscale"):
            self.register_buffer(f"bank_{name}", getattr(prepared, name))
        self.param_names = sorted(kernel_params or {})
        for name in self.param_names:
            self.register_buffer(name, torch.as_tensor(kernel_params[name]).detach().clone())

    def bank(self) -> PreparedSupport:
        return PreparedSupport(self.bank_s, self.bank_s2, self.bank_labels, self.bank_sscale,
                               self.block_s)

    def kernel_params(self) -> dict:
        return {name: getattr(self, name) for name in self.param_names}

    def forward(self, qfeat: torch.Tensor) -> torch.Tensor:
        return nw_fused_from_prepared(qfeat, self.bank(), self.n_classes, kernel=self.kernel,
                                      kernel_params=self.kernel_params())


class IVFHead(PreparedHead):
    """The IVF-pruned serving head (K6 over the routed tiles) as a module:
    ``PreparedHead``'s buffers over the IVF bank's tiled bank, its routing
    index (``cents``, ``c2``, ``cvalid``) as buffers, and ``n_probe`` and
    ``group_b`` fixed; every shape is static (``ops/ivf.py``)."""

    def __init__(self, ivf: IVFPrepared, n_classes: int, kernel: str,
                 kernel_params: Optional[dict], n_probe: int, group_b: Optional[int]) -> None:
        super().__init__(ivf.prep, n_classes, kernel, kernel_params)
        for name in ("cents", "c2", "cvalid"):
            self.register_buffer(name, getattr(ivf, name))
        self.n_probe, self.group_b = min(n_probe, ivf.cents.shape[0]), group_b

    def forward(self, qfeat: torch.Tensor) -> torch.Tensor:
        ivf = IVFPrepared(self.bank(), self.cents, self.c2, self.cvalid)
        return nw_fused_ivf_log_probs(qfeat, ivf, self.n_classes, kernel=self.kernel,
                                      kernel_params=self.kernel_params(), n_probe=self.n_probe,
                                      group_b=self.group_b)
