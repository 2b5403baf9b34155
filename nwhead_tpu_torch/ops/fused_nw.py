"""Fused NW head over a prepared support bank: the serving path.

Port of the serving half of ``nwhead_tpu/ops/pallas_nw.py``
(``prepare_support``, ``_resolve_mode``, ``nw_fused_from_prepared`` and the
Pallas kernel ``_nw_prepared_kernel`` behind ``_prepared_call``). It holds
no Pallas: the kernel is CUDA C++ for Hopper (``csrc/nw_prepared.cu``),
built and loaded by ``ops/_cuda.py``.

``prepare_support`` normalizes the bank once for its kernel, zeroes masked
rows, precomputes the self-norms ``s2`` (l2 modes; ``1e30`` on masked rows)
and stores the labels with ``-1`` for masked rows. Every call then streams
the bank once: score -> online softmax -> label sum -> ``log(acc/l + 1e-12)``.

Two implementations of that pass sit side by side:

* ``_nw_prepared_plain`` — plain PyTorch at full f32 (``torch.matmul``). The
  CPU path and the oracle the CUDA kernel is held to.
* ``nw_prepared_cuda`` — the wrapper of the CUDA kernel. It counts its
  launches in ``nw_prepared_cuda.launches``.

``nw_fused_from_prepared`` picks one from the query tensor's device: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel. There is no
fallback between them: a kernel that cannot be built or launched raises.

Left out of the port, as TPU layout workarounds that change no value: the
lane/sublane label pair, the one-hot matmul and its class window, 128-lane
padding of D, ``meta_stream`` and the query pre-doubling. The int8/int4
banks (K4/K5), tile selection and partial outputs (K6) are later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops.kernels import _l2_normalize
from nwhead_tpu_torch.ops.nw import LOG_FLOOR

# jnp.finfo(float32).min: the JAX kernels' finite "-inf", so that
# ``m > NEG / 2`` tells a real running max from an all-masked one.
_NEG_INF = float(torch.finfo(torch.float32).min)
_MASK_S2 = 1e30  # self-norm of a masked row (l2 modes)
_PRECISIONS = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel -> (mode, L2-normalize the features first)
_MODES = {
    "euclidean": ("l2", False),
    "hypersphere_euclidean": ("l2", True),
    "cosine": ("dot", True),
    "dotproduct": ("dot", False),
    "clip": ("dot", True),
}


class PreparedSupport(NamedTuple):
    """A support bank prepared once for repeated fused inference.

    Rows may be permuted (class-sorted when C > 128); ``prepare_support(...,
    return_order=True)`` returns the permutation."""

    s: torch.Tensor  # (S, D) f32 or bf16, normalized per kernel, masked rows 0
    s2: Optional[torch.Tensor]  # (S,) f32 self-norms (l2 modes), 1e30 if masked
    labels: torch.Tensor  # (S,) int32, -1 = masked


def _resolve_mode(
    kernel: str,
    kernel_params: Dict[str, Any],
    q: torch.Tensor,
    s: Optional[torch.Tensor] = None,
) -> Tuple[str, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Reduce the five kernels to ``(mode, scale, q', s')``: mode ``'l2'``
    or ``'dot'``; ``scale`` a 1-element f32 tensor on ``q``'s device."""
    if kernel not in _MODES:
        raise NotImplementedError(f"fused kernel does not support {kernel!r}")
    mode, norm = _MODES[kernel]
    if kernel == "clip":
        scale = torch.exp(
            torch.as_tensor(kernel_params["logit_scale"], device=q.device)
        ).to(torch.float32).reshape(1)
    else:
        scale = torch.ones(1, dtype=torch.float32, device=q.device)
    if norm:
        q = _l2_normalize(q)
        s = None if s is None else _l2_normalize(s)
    return mode, scale, q, s


def prepare_support(
    sfeat: torch.Tensor,
    sy,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    support_mask: Optional[torch.Tensor] = None,
    precision: str = "f32",
    return_order: bool = False,
):
    """Normalize and pack a support bank for ``nw_fused_from_prepared``.

    The bank stays on ``sfeat``'s device. With ``n_classes > 128`` the rows
    are sorted by class (masked rows last), the permutation the JAX
    package applies, so prepared row positions agree between the two.
    ``return_order=True`` also returns that permutation as an int64 numpy
    array (``order[j]`` = input row stored at prepared row ``j``), or
    ``None`` when rows kept their input order.
    """
    if precision in ("int8", "int4"):
        raise NotImplementedError(
            f"precision={precision!r} banks are not ported yet "
            "(ROADMAP.md queue 2, K4/K5)"
        )
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if sfeat.dim() != 2 or sfeat.shape[0] == 0:
        raise ValueError(f"support must be a non-empty (S, D) array, got {tuple(sfeat.shape)}")
    device = sfeat.device
    sy_np = np.asarray(torch.as_tensor(sy).cpu()).astype(np.int64)
    mask_np = (
        np.ones(len(sy_np), np.float32) if support_mask is None
        else np.asarray(torch.as_tensor(support_mask).cpu(), np.float32)
    )
    if len(sy_np) != sfeat.shape[0] or len(mask_np) != sfeat.shape[0]:
        raise ValueError("features, labels and mask must have one row each")
    if sy_np.max() >= n_classes:
        raise ValueError(f"label {int(sy_np.max())} out of range for n_classes={n_classes}")
    order = None
    if n_classes > 128:
        # Stable sort by class, masked rows last (pallas_nw.py:298-310).
        order = np.argsort(np.where(mask_np > 0, sy_np, n_classes), kind="stable")
        sfeat = sfeat[torch.as_tensor(order, device=device)]
        sy_np, mask_np = sy_np[order], mask_np[order]
    # bf16 banks round before the kernel normalization, as the JAX package does.
    s = sfeat.to(_PRECISIONS[precision])
    mode, _, _, s = _resolve_mode(kernel, {"logit_scale": 0.0}, s[:1], s)
    valid = torch.as_tensor(mask_np > 0, device=device)
    # Masked rows may hold anything, NaN included; where, not multiply.
    s = torch.where(valid[:, None], s, torch.zeros((), dtype=s.dtype, device=device))
    s2 = None
    if mode == "l2":
        sf = s.to(torch.float32)
        s2 = torch.where(valid, torch.sum(sf * sf, dim=1),
                         torch.full((), _MASK_S2, device=device))
    labels = torch.as_tensor(np.where(mask_np > 0, sy_np, -1).astype(np.int32), device=device)
    prep = PreparedSupport(s=s.contiguous(), s2=s2, labels=labels)
    if return_order:
        return prep, (None if order is None else order.astype(np.int64))
    return prep


def _nw_prepared_plain(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, at full f32: ``q`` already in
    the bank's dtype, products and softmax state in f32."""
    qf, sf = q.to(torch.float32), prep.s.to(torch.float32)
    dot = torch.matmul(qf, sf.T)
    if mode == "l2":
        q2 = torch.sum(qf * qf, dim=1, keepdim=True)
        score = -torch.sqrt(torch.clamp(q2 - 2.0 * dot + prep.s2[None, :], min=0.0))
    else:
        score = dot * scale
    valid = prep.labels >= 0
    score = torch.where(valid[None, :], score, _NEG_INF)
    m = torch.max(score, dim=1, keepdim=True).values
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(score > _NEG_INF / 2, torch.exp(score - m_safe), 0.0)
    l = torch.sum(p, dim=1, keepdim=True)
    # Masked rows carry p == 0; they sum into a spare column that is dropped.
    cls = torch.where(valid, prep.labels, n_classes).long()
    acc = torch.zeros(q.shape[0], n_classes + 1, device=q.device).index_add_(1, cls, p)
    return torch.log(acc[:, :n_classes] / torch.clamp(l, min=1e-30) + LOG_FLOOR)


def _split_rows(n_rows: int, n_query_tiles: int, n_sms: int, tile: int) -> Tuple[int, int]:
    """Support rows per split and the split count: enough splits that the
    grid (query tiles x splits) holds about 8 blocks per SM, so that blocks
    waiting on memory are covered by others (a block does not prefetch),
    and no split shorter than one tile. On an H100 at the CUB-200 bank this
    beat 2 and 4 blocks per SM at B=64 and matched 4 at B=256."""
    want = max(1, math.ceil(8 * n_sms / n_query_tiles))
    rows = max(tile, math.ceil(n_rows / want))
    rows = math.ceil(rows / tile) * tile
    return rows, math.ceil(n_rows / rows)


def nw_prepared_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int,
) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/nw_prepared.cu``) on the current
    stream: pass 1 writes per-split partials (m, l, acc), pass 2 merges them
    and takes the log. Raises on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"nw_prepared_cuda needs CUDA tensors, got {q.device}")
    s, labels, s2 = prep.s, prep.labels, prep.s2
    if q.dim() != 2 or q.shape[1] != s.shape[1] or q.shape[0] == 0:
        raise ValueError(f"query {tuple(q.shape)} does not match bank {tuple(s.shape)}")
    if q.dtype != s.dtype or s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"query {q.dtype} / bank {s.dtype}: need one of f32, bf16")
    l2 = mode == "l2"
    if l2 and s2 is None:
        raise ValueError("l2 mode needs the bank's self-norms")
    checked = [("bank", s, s.dtype), ("labels", labels, torch.int32),
               ("scale", scale, torch.float32)] + ([("s2", s2, torch.float32)] if l2 else [])
    for name, t, dt in checked:
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _cuda.load_library()
    if n_classes < 1 or n_classes > lib.nw_prepared_max_classes(q.device.index or 0):
        raise ValueError(f"n_classes={n_classes} is beyond what the kernel's "
                         "shared-memory accumulator holds on this device")
    B, D = q.shape
    S = s.shape[0]
    q = q.contiguous()
    n_tiles_q = math.ceil(B / lib.nw_prepared_query_tile())
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, n_splits = _split_rows(S, n_tiles_q, n_sms, lib.nw_prepared_support_tile())
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((n_splits, B), **f32)
    l_part = torch.empty((n_splits, B), **f32)
    acc_part = torch.empty((n_splits, B, n_classes), **f32)
    out = torch.empty((B, n_classes), **f32)
    with torch.cuda.device(q.device):
        rc = lib.nw_prepared_forward(
            q.data_ptr(), s.data_ptr(), s2.data_ptr() if l2 else None,
            labels.data_ptr(), scale.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), B, S, D, n_classes, int(l2),
            int(s.dtype == torch.bfloat16), n_splits, rows,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"nw_prepared kernel launch failed: {lib.nw_prepared_error_string(rc).decode()}"
        )
    nw_prepared_cuda.launches += 1
    return out


nw_prepared_cuda.launches = 0


def nw_fused_from_prepared(
    qfeat: torch.Tensor,
    prepared: PreparedSupport,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Fused NW log-probs ``(B, C)`` over a ``prepare_support`` bank.
    Inference only. The query is normalized in f32, then cast to the
    bank's dtype."""
    mode, scale, qn, _ = _resolve_mode(kernel, kernel_params or {}, qfeat)
    q = qn.to(prepared.s.dtype)
    if q.device.type == "cpu":
        return _nw_prepared_plain(q, prepared, scale, mode, n_classes)
    return nw_prepared_cuda(q, prepared, scale, mode, n_classes)
