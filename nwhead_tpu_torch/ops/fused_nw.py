"""Fused NW head: the raw differentiable path (training) and the prepared
serving path.

Port of ``nwhead_tpu/ops/pallas_nw.py``: ``prepare_support``,
``_resolve_mode``, ``nw_fused_log_probs`` with its custom VJP, and
``nw_fused_from_prepared``. It holds no Pallas: the kernels are CUDA C++
for Hopper, built and loaded by ``ops/_cuda.py``:

* K1 ``csrc/nw_fused.cu`` ``nw_fused_forward`` (TPU ``_nw_fwd_kernel``):
  raw features in, log-probs and the softmax statistics ``(m, l)`` out;
* K3 ``csrc/nw_fused.cu`` ``nw_fused_bwd_dq`` / ``nw_fused_bwd_ds`` (TPU
  ``_nw_bwd_dq_kernel`` / ``_nw_bwd_ds_kernel``): the backward, recomputing
  the scores from ``(m, l)``;
* K2 ``csrc/nw_prepared.cu`` (TPU ``_nw_prepared_kernel``): the forward
  over a bank normalized and packed once by ``prepare_support``.

``prepare_support`` normalizes the bank once for its kernel, zeroes masked
rows, precomputes the self-norms ``s2`` (l2 modes; ``1e30`` on masked rows)
and stores the labels with ``-1`` for masked rows. Every call then streams
the bank once: score -> online softmax -> label sum -> ``log(acc/l + 1e-12)``.

Each kernel has a wrapper that counts its launches (``.launches``) and a
plain PyTorch version of the same function (``_nw_fwd_plain``,
``_nw_bwd_dq_plain``, ``_nw_bwd_ds_plain``, or both passes at once in
``_nw_bwd_plain``, ``_nw_prepared_plain``; full f32 products). A CPU
tensor goes to the plain version, a CUDA tensor to the kernel. There is no
fallback between them: a kernel that cannot be built or launched raises.

Left out of the port, as TPU layout workarounds that change no value: the
lane/sublane label pair, the one-hot matmuls (label sum and the ``u[y]``
gather), the class window, 128-lane padding of D, the ones-vector column
sum, ``meta_stream`` and the query pre-doubling. The int8/int4 banks
(K4/K5), tile selection and partial outputs (K1 ``partials=True``, K6) are
later slices.
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


def _scores_plain(qf, sf, s2, labels, scale, mode):
    """The f32 score matrix ``(B, S)`` of the fused kernels, masked rows
    ``_NEG_INF``, and (l2 mode) the distances, else ``None``."""
    dot = torch.matmul(qf, sf.T)
    dist = None
    if mode == "l2":
        q2 = torch.sum(qf * qf, dim=1, keepdim=True)
        dist = torch.sqrt(torch.clamp(q2 - 2.0 * dot + s2[None, :], min=0.0))
        score = -dist
    else:
        score = dot * scale
    return torch.where((labels >= 0)[None, :], score, _NEG_INF), dist


def _softmax_pass_plain(score, labels, n_classes):
    """``(out, m, l)`` of the online-softmax pass, computed at once."""
    m = torch.max(score, dim=1, keepdim=True).values
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(score > _NEG_INF / 2, torch.exp(score - m_safe), 0.0)
    l = torch.sum(p, dim=1, keepdim=True)
    # Masked rows carry p == 0; they sum into a spare column that is dropped.
    cls = torch.where(labels >= 0, labels, n_classes).long()
    acc = torch.zeros(score.shape[0], n_classes + 1, dtype=score.dtype,
                      device=score.device).index_add_(1, cls, p)
    out = torch.log(acc[:, :n_classes] / torch.clamp(l, min=1e-30) + LOG_FLOOR)
    return out, m, l


def _nw_prepared_plain(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int,
) -> torch.Tensor:
    """K2's function in plain PyTorch, at full f32: ``q`` already in the
    bank's dtype, products and softmax state in f32."""
    score, _ = _scores_plain(q.to(torch.float32), prep.s.to(torch.float32), prep.s2,
                             prep.labels, scale, mode)
    return _softmax_pass_plain(score, prep.labels, n_classes)[0]


def _plain_float(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the plain versions' arithmetic: f32, or f64 for f64 inputs
    (an f64 evaluation of the same formula is the exact reference where
    a query coincides with a support row, whose f32 distance is rounding
    residue)."""
    return x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)


def _raw_support_plain(s: torch.Tensor, labels: torch.Tensor):
    """Raw rows in f32 (see ``_plain_float``) with masked rows zeroed (by
    selection: they may hold NaN), and their self-norms."""
    sf = torch.where((labels >= 0)[:, None], _plain_float(s), 0.0)
    return sf, torch.sum(sf * sf, dim=1)


def _nw_fwd_plain(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: ``(out (B, C), m (B, 1), l (B, 1))``
    in f32 (see ``_plain_float``) from raw ``q (B, D)`` and ``s (S, D)`` of
    one dtype."""
    sf, s2 = _raw_support_plain(s, labels)
    score, _ = _scores_plain(_plain_float(q), sf, s2, labels, scale, mode)
    return _softmax_pass_plain(score, labels, n_classes)


def _bwd_pair_weights_plain(q, s, labels, u, r, m, l, scale, mode):
    """K3's recompute in plain PyTorch: ``(qf, sf, t)`` with the inputs in
    f32 (see ``_plain_float``; masked rows zeroed) and the ``(B, S)`` weight of each pair in the
    gradient, ``dscore / dist`` in l2 mode (0 where ``dist == 0``), else
    ``dscore``. The scores come from the saved ``(m, l)`` (each ``(B, 1)``);
    ``u (B, C)`` and ``r (B, 1)`` from the upstream gradient."""
    qf = _plain_float(q)
    sf, s2 = _raw_support_plain(s, labels)
    score, dist = _scores_plain(qf, sf, s2, labels, scale, mode)
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(score > _NEG_INF / 2, torch.exp(score - m_safe), 0.0)
    w = p / torch.clamp(l, min=1e-30)
    uy = u[:, labels.clamp(min=0).long()]  # u[b, y_j]; masked rows have w == 0
    dscore = w * (uy - r)
    if mode != "l2":
        return qf, sf, dscore
    pos = dist > 0.0
    return qf, sf, torch.where(pos, dscore / torch.where(pos, dist, 1.0), 0.0)


def _dq_from_weights(qf, sf, t, scale, mode):
    if mode == "l2":
        return torch.matmul(t, sf) - qf * torch.sum(t, dim=1, keepdim=True)
    return scale * torch.matmul(t, sf)


def _ds_from_weights(qf, sf, t, scale, mode):
    if mode == "l2":
        return torch.matmul(t.T, qf) - sf * torch.sum(t, dim=0)[:, None]
    return scale * torch.matmul(t.T, qf)


def _nw_bwd_plain(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, u: torch.Tensor,
    r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: ``(dq, ds)`` in the inputs' dtype
    (see ``_bwd_pair_weights_plain``). Masked rows get a zero gradient."""
    qf, sf, t = _bwd_pair_weights_plain(q, s, labels, u, r, m, l, scale, mode)
    return (_dq_from_weights(qf, sf, t, scale, mode).to(q.dtype),
            _ds_from_weights(qf, sf, t, scale, mode).to(s.dtype))


def _nw_bwd_dq_plain(q, s, labels, u, r, m, l, scale, mode, n_classes) -> torch.Tensor:
    """K3's dq pass alone in plain PyTorch."""
    qf, sf, t = _bwd_pair_weights_plain(q, s, labels, u, r, m, l, scale, mode)
    return _dq_from_weights(qf, sf, t, scale, mode).to(q.dtype)


def _nw_bwd_ds_plain(q, s, labels, u, r, m, l, scale, mode, n_classes) -> torch.Tensor:
    """K3's ds pass alone in plain PyTorch."""
    qf, sf, t = _bwd_pair_weights_plain(q, s, labels, u, r, m, l, scale, mode)
    return _ds_from_weights(qf, sf, t, scale, mode).to(s.dtype)


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


def _check_raw(name: str, q: torch.Tensor, s: torch.Tensor, tensors) -> None:
    """The checks every raw-path wrapper makes before its launch."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dim() != 2 or s.dim() != 2 or q.shape[1] != s.shape[1] or 0 in (*q.shape, *s.shape):
        raise ValueError(f"{name}: query {tuple(q.shape)} and support {tuple(s.shape)} "
                         "must be non-empty (B, D) and (S, D)")
    if q.dtype != s.dtype or s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"query {q.dtype} / support {s.dtype}: need one of f32, bf16")
    for arg, t, dt in [("query", q, s.dtype), ("support", s, s.dtype), *tensors]:
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs contiguous {dt} on {q.device}, "
                             f"got {t.dtype} on {t.device}")


def _launch(lib, fn: str, *args) -> None:
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: {lib.nw_fused_error_string(rc).decode()}")


def _fused_library(q: torch.Tensor):
    """The K1/K3 library, the device index and the card's SM count."""
    lib = _cuda.load_library("nw_fused")
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return lib, q.device.index or 0, n_sms


def nw_fwd_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 (``csrc/nw_fused.cu``) on the current stream: pass 1 over
    (query tiles x support splits) writes partials, pass 2 merges them into
    ``out (B, C)`` and the statistics ``m, l (B, 1)``."""
    _check_raw("nw_fwd_cuda", q, s, [("labels", labels, torch.int32),
                                     ("scale", scale, torch.float32)])
    lib, dev, n_sms = _fused_library(q)
    if n_classes < 1 or n_classes > lib.nw_fused_max_classes(dev):
        raise ValueError(f"n_classes={n_classes} is beyond what the kernel's "
                         "shared-memory accumulator holds on this device")
    (B, D), S = q.shape, s.shape[0]
    rows, n_splits = _split_rows(S, math.ceil(B / lib.nw_fused_query_tile()), n_sms,
                                 lib.nw_fused_support_tile())
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part, l_part = torch.empty((n_splits, B), **f32), torch.empty((n_splits, B), **f32)
    acc_part = torch.empty((n_splits, B, n_classes), **f32)
    out, m, l = torch.empty((B, n_classes), **f32), torch.empty(B, **f32), torch.empty(B, **f32)
    with torch.cuda.device(q.device):
        _launch(lib, "nw_fused_forward", q.data_ptr(), s.data_ptr(), labels.data_ptr(),
                scale.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                out.data_ptr(), m.data_ptr(), l.data_ptr(), B, S, D, n_classes,
                int(mode == "l2"), int(s.dtype == torch.bfloat16), n_splits, rows,
                torch.cuda.current_stream(q.device).cuda_stream)
    nw_fwd_cuda.launches += 1
    return out, m[:, None], l[:, None]


nw_fwd_cuda.launches = 0


def _bwd_tensors(q, u, r, m, l, n_classes):
    """The f32 per-query inputs of K3, flattened and checked."""
    B = q.shape[0]
    if u.shape != (B, n_classes) or r.numel() != B or m.numel() != B or l.numel() != B:
        raise ValueError(f"u {tuple(u.shape)}, r/m/l need ({B}, {n_classes}) and {B} values")
    r, m, l = (t.reshape(-1).contiguous() for t in (r, m, l))
    return [("u", u, torch.float32), ("r", r, torch.float32), ("m", m, torch.float32),
            ("l", l, torch.float32)]


def nw_bwd_dq_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, u: torch.Tensor,
    r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> torch.Tensor:
    """Launch K3's dq pass (``csrc/nw_fused.cu``): per-split partials over
    (query tiles x support splits), then their sum in a fixed order.
    Returns ``dq (B, D)`` in ``q``'s dtype."""
    per_query = _bwd_tensors(q, u, r, m, l, n_classes)
    _check_raw("nw_bwd_dq_cuda", q, s, [("labels", labels, torch.int32),
                                        ("scale", scale, torch.float32), *per_query])
    lib, dev, n_sms = _fused_library(q)
    (B, D), S = q.shape, s.shape[0]
    if D > lib.nw_fused_dq_max_features(dev):
        raise ValueError(f"D={D} is beyond the dq pass's shared-memory accumulator")
    rows, n_splits = _split_rows(S, math.ceil(B / lib.nw_fused_query_tile()), n_sms,
                                 lib.nw_fused_support_tile())
    ts = torch.empty((n_splits, B, D), dtype=torch.float32, device=q.device)
    tsum = torch.empty((n_splits, B), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch(lib, "nw_fused_bwd_dq", q.data_ptr(), s.data_ptr(), labels.data_ptr(),
                *(t.data_ptr() for _, t, _ in per_query), scale.data_ptr(), ts.data_ptr(),
                tsum.data_ptr(), dq.data_ptr(), B, S, D, n_classes, int(mode == "l2"),
                int(s.dtype == torch.bfloat16), n_splits, rows,
                torch.cuda.current_stream(q.device).cuda_stream)
    nw_bwd_dq_cuda.launches += 1
    return dq


nw_bwd_dq_cuda.launches = 0


def nw_bwd_ds_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, u: torch.Tensor,
    r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> torch.Tensor:
    """Launch K3's ds pass (``csrc/nw_fused.cu``): one block per 64 support
    rows, each looping over every query tile. Returns ``ds (S, D)`` in
    ``s``'s dtype."""
    per_query = _bwd_tensors(q, u, r, m, l, n_classes)
    _check_raw("nw_bwd_ds_cuda", q, s, [("labels", labels, torch.int32),
                                        ("scale", scale, torch.float32), *per_query])
    lib, dev, _ = _fused_library(q)
    (B, D), S = q.shape, s.shape[0]
    if B > lib.nw_fused_ds_max_batch(dev):
        raise ValueError(f"B={B} is beyond the ds pass's shared-memory buffer")
    ds = torch.empty_like(s)
    with torch.cuda.device(q.device):
        _launch(lib, "nw_fused_bwd_ds", q.data_ptr(), s.data_ptr(), labels.data_ptr(),
                *(t.data_ptr() for _, t, _ in per_query), scale.data_ptr(), ds.data_ptr(),
                B, S, D, n_classes, int(mode == "l2"), int(s.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    nw_bwd_ds_cuda.launches += 1
    return ds


nw_bwd_ds_cuda.launches = 0


class _NWFusedCore(torch.autograd.Function):
    """``out = log(acc/l + 1e-12)`` over raw features, differentiable in
    ``q``, ``s`` and ``scale`` (the custom VJP ``_nw_fused_core`` of the JAX
    package). Forward: K1, saving ``(m, l)``. Backward: ``u = g e^-out`` and
    ``r = sum_c u (e^out - 1e-12)`` here, then K3 for ``dq`` and ``ds``; in
    dot mode ``dscale = sum(q dq) / scale``."""

    @staticmethod
    def forward(ctx, q, s, scale, labels, mode, n_classes):
        fwd = _nw_fwd_plain if q.device.type == "cpu" else nw_fwd_cuda
        out, m, l = fwd(q, s, labels, scale, mode, n_classes)
        ctx.save_for_backward(q, s, scale, labels, out, m, l)
        ctx.mode, ctx.n_classes = mode, n_classes
        return out

    @staticmethod
    def backward(ctx, g):
        q, s, scale, labels, out, m, l = ctx.saved_tensors
        u = (g * torch.exp(-out)).to(torch.float32).contiguous()
        r = torch.sum(u * (torch.exp(out) - LOG_FLOOR), dim=-1, keepdim=True)
        args = (q, s, labels, u, r, m, l, scale, ctx.mode, ctx.n_classes)
        if q.device.type == "cpu":
            dq, ds = _nw_bwd_plain(*args)
        else:
            dq, ds = nw_bwd_dq_cuda(*args), nw_bwd_ds_cuda(*args)
        dscale = None
        if ctx.needs_input_grad[2]:
            dscale = (torch.sum(q.to(torch.float32) * dq.to(torch.float32)) / scale
                      if ctx.mode == "dot" else torch.zeros_like(scale))
        return dq, ds, dscale, None, None, None


def nw_fused_log_probs(
    qfeat: torch.Tensor,
    sfeat,
    sy=None,
    n_classes: Optional[int] = None,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    support_mask: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Fused NW head: ``log(softmax(kernel(q, s)) @ onehot(sy) + 1e-12)``.

    The contract of ``nw_log_probs`` restricted to 2-D shared support,
    differentiable in ``q``, ``s`` and clip's ``logit_scale``. ``sfeat`` may
    be a ``PreparedSupport`` (``sy`` is then ignored): the inference-only
    serving path (K2). ``precision='bf16'`` casts both feature sets to bf16
    before the kernel normalization; products and softmax stay f32 and the
    gradients come back through the cast."""
    if isinstance(sfeat, PreparedSupport):
        if n_classes is None:
            raise ValueError("n_classes is required with a PreparedSupport")
        if support_mask is not None:
            raise ValueError("support_mask must be baked in at prepare_support time "
                             "(the prepared bank's labels already encode the mask)")
        bank = {torch.float32: "f32", torch.bfloat16: "bf16"}[sfeat.s.dtype]
        if precision is not None and precision != bank:
            raise ValueError(f"precision={precision!r} but the prepared bank is {bank} "
                             "— pass precision= to prepare_support instead")
        return nw_fused_from_prepared(qfeat, sfeat, n_classes, kernel=kernel,
                                      kernel_params=kernel_params)
    if sy is None or n_classes is None:
        raise ValueError("the raw fused path needs the support labels and n_classes")
    precision = precision or "f32"
    if precision not in _PRECISIONS:
        raise ValueError(f"the raw fused path runs at f32 or bf16, got {precision!r}")
    if qfeat.dim() != 2 or sfeat.dim() != 2 or qfeat.shape[1] != sfeat.shape[1]:
        raise ValueError(f"the fused head takes 2-D query (B, D) and support (S, D), got "
                         f"{tuple(qfeat.shape)} and {tuple(sfeat.shape)}")
    labels = torch.as_tensor(sy, device=sfeat.device).to(torch.int32)
    if labels.shape != (sfeat.shape[0],):
        raise ValueError(f"{tuple(labels.shape)} labels for {sfeat.shape[0]} support rows")
    if support_mask is not None:
        valid = torch.as_tensor(support_mask, device=sfeat.device) > 0
        labels = torch.where(valid, labels, torch.full_like(labels, -1))
        # Masked rows may hold NaN: zero them by selection before the
        # normalization, whose backward would turn their 0 gradient into NaN.
        sfeat = torch.where(valid[:, None], sfeat, torch.zeros((), dtype=sfeat.dtype,
                                                               device=sfeat.device))
    if precision == "bf16":
        qfeat, sfeat = qfeat.to(torch.bfloat16), sfeat.to(torch.bfloat16)
    mode, scale, qn, sn = _resolve_mode(kernel, kernel_params or {}, qfeat, sfeat)
    return _NWFusedCore.apply(qn.to(sn.dtype).contiguous(), sn.contiguous(), scale,
                              labels.contiguous(), mode, n_classes)


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
