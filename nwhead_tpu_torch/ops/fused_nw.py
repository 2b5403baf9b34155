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
* K2 ``csrc/nw_prepared.cu`` ``nw_prepared_forward`` (TPU
  ``_nw_prepared_kernel``): the forward over a bank normalized and packed
  once by ``prepare_support``, f32 or bf16;
* K4 and K5 ``csrc/nw_prepared.cu`` ``nw_prepared_quant_forward`` (TPU
  ``_nw_prepared_kernel`` with ``quant=True`` / ``quant4=True``): the same
  over an int8 bank, or an int4 bank of two codes a byte, against a query
  quantized per row; int32 dot products, dequantized by the query's and the
  row's scales;
* K6 ``csrc/nw_prepared.cu`` ``nw_prepared_sel_forward`` (TPU
  ``_nw_prepared_kernel`` with ``tile_sel``): K2/K4/K5's pass over only the
  bank tiles a list names (IVF-pruned serving, ``ops/ivf.py``), one list for
  the batch or one per query group.

K1 and K2/K4/K5/K6 also run unfinalized (TPU ``partials=True``:
``nw_fused_partials``, ``nw_fused_from_prepared(partials=True)``): the same
pass 1, then a merge of the splits that stops before the log and returns
``(m, l, acc)``, which a support-sharded bank (``parallel/sharded_bank.py``)
or a host-streamed one (``nw/streaming.py``) merges across its shards or
chunks. Each has its own wrapper and launch count (``nw_fwd_partials_cuda``,
``nw_prepared_partials_cuda``, ``nw_prepared_partials_int8_cuda``,
``nw_prepared_partials_int4_cuda``, ``nw_prepared_sel_partials_cuda``,
``nw_prepared_sel_partials_quant_cuda``) and plain version
(``_nw_fwd_partials_plain``, ``_nw_prepared_plain(partials=True)``,
``_nw_prepared_sel_plain(partials=True)``).

``prepare_support`` normalizes the bank once for its kernel, zeroes masked
rows, quantizes it per row for ``int8``/``int4`` (symmetric, ``amax/127``
or ``amax/7``, codes ``round(x / scale)``), precomputes the self-norms
``s2`` (l2 modes; of the dequantized bank for int8/int4; ``1e30`` on masked
rows) and stores the labels with ``-1`` for masked rows. Every call then
streams the bank once: score -> online softmax -> label sum ->
``log(acc/l + 1e-12)``.

Each kernel has a wrapper that counts its launches (``.launches``) and a
plain PyTorch version of the same function (``_nw_fwd_plain``,
``_nw_bwd_dq_plain``, ``_nw_bwd_ds_plain``, or both passes at once in
``_nw_bwd_plain``, ``_nw_prepared_plain``, ``_nw_prepared_sel_plain``; full
f32 products, and for the quantized banks the integer dot products exactly,
in f64). A CPU tensor
goes to the plain version, a CUDA tensor to the kernel. There is no
fallback between them: a kernel that cannot be built or launched raises.

Left out of the port, as TPU layout workarounds that change no value: the
lane/sublane label pair, the one-hot matmuls (label sum and the ``u[y]``
gather), the class window, 128-lane padding of D (an int8 bank pads D to a
multiple of 4, an int4 bank to a multiple of 8, so that rows and packed
halves are whole 32-bit words), the ones-vector column sum,
``meta_stream``, the query pre-doubling and the int4 unpack variants.
"""

from __future__ import annotations

import math
import warnings
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
# Quantized banks: precision -> (stored dtype, largest code, D padded to a
# multiple of). The int4 bank is stored as uint8, two codes a byte: the
# dtype marks it, as in the JAX package.
_QUANT = {"int8": (torch.int8, 127.0, 4), "int4": (torch.uint8, 7.0, 8)}
_BANK_PRECISION = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8",
                   torch.uint8: "int4"}
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
    return_order=True)`` returns the permutation. A bank prepared with
    ``block_s`` is padded with masked rows to whole tiles: tile ``t`` is rows
    ``[t * block_s, (t + 1) * block_s)``, the unit ``tile_sel`` names."""

    # (S, D) f32 or bf16, normalized per kernel, masked rows 0; int8: (S,
    # D_pad) codes; int4: (S, D_pad / 2) uint8, byte j = (code[j + D_pad/2]
    # << 4) | (code[j] + 8).
    s: torch.Tensor
    s2: Optional[torch.Tensor]  # (S,) f32 self-norms (l2 modes), 1e30 if masked
    labels: torch.Tensor  # (S,) int32, -1 = masked
    sscale: Optional[torch.Tensor] = None  # (S,) f32 row scales of an int8/int4 bank
    block_s: Optional[int] = None  # rows per tile (a multiple of 128), or None: untiled


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
    block_s: Optional[int] = None,
    keep_order: bool = False,
    return_order: bool = False,
):
    """Normalize and pack a support bank for ``nw_fused_from_prepared``.

    The bank stays on ``sfeat``'s device. With ``n_classes > 128`` the rows
    are sorted by class (masked rows last), the permutation the JAX
    package applies, so prepared row positions agree between the two.
    ``return_order=True`` also returns that permutation as an int64 numpy
    array (``order[j]`` = input row stored at prepared row ``j``), or
    ``None`` when rows kept their input order.

    ``precision='int8'`` / ``'int4'`` quantize each normalized row
    symmetrically (``pallas_nw.py:343-362``): scale ``amax/127`` (or
    ``amax/7``; 1 for an all-zero row), codes ``clip(round(x / scale))``;
    the int4 codes are packed two a byte (``_int4_pack``).

    ``block_s`` tiles the bank for ``tile_sel``: the tile size becomes
    ``min(round_up(block_s, 128), round_up(S, 128))``, as the JAX package
    resolves it, and the bank is padded to whole tiles with masked rows
    (label -1, zero features, self-norm ``1e30``, scale 1).
    ``keep_order=True`` skips the class sort (the JAX package's
    ``window="keep"``): ``prepare_support_ivf`` has ordered the rows already.
    """
    if precision not in _PRECISIONS and precision not in _QUANT:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "int4" and kernel == "dotproduct":
        # As the JAX package warns (pallas_nw.py:278-288): raw dot scores are
        # unbounded, so 4-bit feature noise goes straight into the softmax.
        warnings.warn(
            "int4 serving banks amplify quantization noise under the raw "
            "dotproduct kernel; prefer precision='int8' there (euclidean/"
            "cosine/clip are fine at int4).",
            stacklevel=2,
        )
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
    if n_classes > 128 and not keep_order:
        # Stable sort by class, masked rows last (pallas_nw.py:298-310).
        order = np.argsort(np.where(mask_np > 0, sy_np, n_classes), kind="stable")
        sfeat = sfeat[torch.as_tensor(order, device=device)]
        sy_np, mask_np = sy_np[order], mask_np[order]
    if block_s is not None:
        # Whole tiles of masked rows (pallas_nw.py:321-325).
        S = sfeat.shape[0]
        block_s = min(_round_up(block_s, 128), _round_up(S, 128))
        pad = _round_up(S, block_s) - S
        sfeat = torch.nn.functional.pad(sfeat, (0, 0, 0, pad))
        sy_np = np.concatenate([sy_np, np.zeros(pad, np.int64)])
        mask_np = np.concatenate([mask_np, np.zeros(pad, np.float32)])
    # bf16 banks round before the kernel normalization, as the JAX package
    # does; quantized banks are normalized in f32.
    s = sfeat.to(_PRECISIONS.get(precision, torch.float32))
    mode, _, _, s = _resolve_mode(kernel, {"logit_scale": 0.0}, s[:1], s)
    valid = torch.as_tensor(mask_np > 0, device=device)
    # Masked rows may hold anything, NaN included; where, not multiply.
    s = torch.where(valid[:, None], s, torch.zeros((), dtype=s.dtype, device=device))
    s2 = sscale = None
    if precision in _QUANT:
        s, sscale, s2 = _quantize_bank(s, precision)
        s2 = s2 if mode == "l2" else None
    elif mode == "l2":
        sf = s.to(torch.float32)
        s2 = torch.sum(sf * sf, dim=1)
    if mode == "l2":
        s2 = torch.where(valid, s2, torch.full((), _MASK_S2, device=device))
    labels = torch.as_tensor(np.where(mask_np > 0, sy_np, -1).astype(np.int32), device=device)
    prep = PreparedSupport(s=s.contiguous(), s2=s2, labels=labels, sscale=sscale,
                           block_s=block_s)
    if return_order:
        return prep, (None if order is None else order.astype(np.int64))
    return prep


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _quantize_bank(s: torch.Tensor, precision: str):
    """``(codes, scale (S,), s2 (S,))`` of a normalized f32 bank with masked
    rows zeroed: int8 codes ``(S, D_pad)``, or int4 codes packed into
    ``(S, D_pad / 2)`` uint8. ``s2`` is the dequantized rows' self-norm,
    summed as the JAX package sums it: ``sum((code * scale)^2)`` for int8,
    ``sum(code^2) * scale * scale`` for int4."""
    _, top, multiple = _QUANT[precision]
    sf = torch.nn.functional.pad(s, (0, _round_up(s.shape[1], multiple) - s.shape[1]))
    amax = torch.amax(torch.abs(sf), dim=1)
    # int4: the JAX package's jitted ``amax / 7`` runs as XLA rewrites it,
    # a multiply by f32(1/7); int8's eager ``amax / 127`` stays a division.
    step = amax / top if precision == "int8" else amax * (1.0 / top)
    scale = torch.where(amax > 0, step, torch.ones((), device=s.device))
    # A division, not a multiply by the reciprocal: the codes at .5 are JAX's.
    codes = torch.clamp(torch.round(sf / scale[:, None]), -top, top)
    if precision == "int8":
        return codes.to(torch.int8), scale, torch.sum((codes * scale[:, None]) ** 2, dim=1)
    return _int4_pack(codes), scale, torch.sum(codes ** 2, dim=1) * scale * scale


def _int4_pack(codes: torch.Tensor) -> torch.Tensor:
    """``(S, D_pad)`` codes in [-7, 7] -> ``(S, D_pad / 2)`` uint8: features
    ``j`` and ``j + D_pad/2`` share byte ``j``, the low nibble biased by 8
    (``pallas_nw.py:211-240``)."""
    c = codes.to(torch.int32)
    half = c.shape[1] // 2
    return (((c[:, half:] & 0xF) << 4) | (c[:, :half] + 8)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The ``(S, D_pad)`` int8 codes of a packed int4 bank."""
    b = packed.to(torch.int32)
    hi = (b >> 4) & 0xF
    return torch.cat([(b & 0xF) - 8, hi - ((hi & 8) << 1)], dim=1).to(torch.int8)


def bank_codes(prep: PreparedSupport) -> torch.Tensor:
    """The ``(S, D_pad)`` int8 codes of an int8 or int4 bank."""
    return unpack_int4(prep.s) if prep.s.dtype == torch.uint8 else prep.s


def _bank_width(prep: PreparedSupport) -> int:
    """The features a query needs for this bank (D_pad for int8/int4)."""
    return prep.s.shape[1] * (2 if prep.s.dtype == torch.uint8 else 1)


def _quantize_query(q: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q8 (B, width) int8, qscale (B,) f32)``: each normalized f32 query
    padded to the bank's width and quantized symmetrically to 127 levels
    (for int4 banks too, ``pallas_nw.py:1328-1333``), by a division."""
    qf = torch.nn.functional.pad(q.to(torch.float32), (0, width - q.shape[1]))
    amax = torch.amax(torch.abs(qf), dim=1)
    qscale = torch.where(amax > 0, amax / 127.0, torch.ones((), device=q.device))
    return torch.clamp(torch.round(qf / qscale[:, None]), -127, 127).to(torch.int8), qscale


def _prepared_query(qfeat: torch.Tensor, prepared: PreparedSupport, kernel: str = "euclidean",
                    kernel_params: Optional[Dict[str, Any]] = None):
    """``(q, scale, mode, qscale)``: a query batch as the bank's kernel takes
    it. The query is normalized in f32, then cast to the bank's dtype, or
    for an int8/int4 bank quantized (``qscale`` its scales, else None)."""
    mode, scale, qn, _ = _resolve_mode(kernel, kernel_params or {}, qfeat)
    if prepared.sscale is None:
        return qn.to(prepared.s.dtype), scale, mode, None
    q8, qscale = _quantize_query(qn, _bank_width(prepared))
    return q8, scale, mode, qscale


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


def _softmax_partials_plain(score, labels, n_classes):
    """``(m, l, acc)`` of the online-softmax pass, computed at once: the
    largest score (``_NEG_INF`` where every row is masked), and the
    normalizer and label sums relative to it."""
    m = torch.max(score, dim=1, keepdim=True).values
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(score > _NEG_INF / 2, torch.exp(score - m_safe), 0.0)
    l = torch.sum(p, dim=1, keepdim=True)
    # Masked rows carry p == 0; they sum into a spare column that is dropped.
    cls = torch.where(labels >= 0, labels, n_classes).long()
    acc = torch.zeros(score.shape[0], n_classes + 1, dtype=score.dtype,
                      device=score.device).index_add_(1, cls, p)
    return m, l, acc[:, :n_classes]


def _softmax_pass_plain(score, labels, n_classes):
    """``(out, m, l)`` of the online-softmax pass, computed at once."""
    m, l, acc = _softmax_partials_plain(score, labels, n_classes)
    return torch.log(acc / torch.clamp(l, min=1e-30) + LOG_FLOOR), m, l


def _quant_scores_plain(q8, qscale, prep, scale, mode):
    """K4/K5's score matrix ``(B, S)``, masked rows ``_NEG_INF``: the int32
    dot product (exact: an f64 product of integers below 2^53), then
    ``dot * qcol * sscale`` in f32 with ``qcol = qscale`` (l2) or ``qscale *
    scale`` (dot: the similarity scale folded into the query's column,
    ``pallas_nw.py:1334-1344``). l2: ``-sqrt(max(q2 - 2 dot + s2, 0))``
    with ``q2`` the dequantized query's norm."""
    dot_i = torch.matmul(q8.to(torch.float64), bank_codes(prep).to(torch.float64).T)
    qcol = qscale if mode == "l2" else qscale * scale
    dot = dot_i.to(torch.float32) * qcol[:, None] * prep.sscale[None, :]
    if mode == "l2":
        qd = q8.to(torch.float32) * qscale[:, None]
        q2 = torch.sum(qd * qd, dim=1, keepdim=True)
        score = -torch.sqrt(torch.clamp(q2 - 2.0 * dot + prep.s2[None, :], min=0.0))
    else:
        score = dot
    return torch.where((prep.labels >= 0)[None, :], score, _NEG_INF)


def _nw_prepared_plain(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None, partials: bool = False,
):
    """K2's function in plain PyTorch, at full f32: ``q`` already in the
    bank's dtype, products and softmax state in f32. For an int8/int4 bank
    (K4/K5) ``q`` is the int8 query and ``qscale`` its scales
    (``_prepared_query``). ``partials=True``: ``(m (B, 1), l (B, 1), acc
    (B, C))`` unfinalized instead of the log-probs."""
    if prep.sscale is not None:
        score = _quant_scores_plain(q, qscale, prep, scale, mode)
    else:
        score, _ = _scores_plain(q.to(torch.float32), prep.s.to(torch.float32), prep.s2,
                                 prep.labels, scale, mode)
    if partials:
        return _softmax_partials_plain(score, prep.labels, n_classes)
    return _softmax_pass_plain(score, prep.labels, n_classes)[0]


def _sel_rows(tile_sel: torch.Tensor, B: int) -> Tuple[torch.Tensor, int]:
    """``tile_sel`` as ``(n_groups, n_sel)`` int32 rows, and the queries of
    each group: one row shared by the batch, or one per ``B / n_groups``
    consecutive queries."""
    sel = tile_sel.to(torch.int32)
    if sel.dim() == 1:
        sel = sel[None]
    if sel.dim() != 2 or 0 in sel.shape:
        raise ValueError(f"tile_sel must be (n_sel,) or (n_groups, n_sel), got "
                         f"{tuple(tile_sel.shape)}")
    if B % sel.shape[0]:
        raise ValueError(f"{sel.shape[0]} tile_sel rows do not split {B} queries into "
                         "equal groups")
    return sel, B // sel.shape[0]


def _nw_prepared_sel_plain(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor], tile_sel: torch.Tensor,
    partials: bool = False,
):
    """K6's function in plain PyTorch: for each query group,
    ``_nw_prepared_plain`` over the rows of its selected tiles gathered in
    slot order. A ``-1`` slot, or an id outside the bank, adds only masked
    rows. Shapes are static: nothing is read back to the host.
    ``partials=True`` returns ``(m, l, acc)`` as ``_nw_prepared_plain``
    does."""
    if prep.block_s is None:
        raise ValueError("tile_sel needs a bank prepared with block_s")
    sel, group_b = _sel_rows(tile_sel, q.shape[0])
    n_tiles = prep.labels.shape[0] // prep.block_s
    offsets = torch.arange(prep.block_s, device=q.device)
    outs = []
    for g in range(sel.shape[0]):
        ids = sel[g].to(q.device).long()
        live = (ids >= 0) & (ids < n_tiles)
        rows = (torch.where(live, ids, 0)[:, None] * prep.block_s + offsets).reshape(-1)
        keep = live[:, None].expand(-1, prep.block_s).reshape(-1)
        sub = PreparedSupport(
            s=prep.s[rows], s2=None if prep.s2 is None else prep.s2[rows],
            labels=torch.where(keep, prep.labels[rows], -1),
            sscale=None if prep.sscale is None else prep.sscale[rows])
        part = slice(g * group_b, (g + 1) * group_b)
        outs.append(_nw_prepared_plain(q[part], sub, scale, mode, n_classes,
                                       None if qscale is None else qscale[part], partials))
    if partials:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


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


def _nw_fwd_partials_plain(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 ``partials=True`` in plain PyTorch: ``(m (B, 1), l (B, 1), acc (B,
    C))`` unfinalized, from the inputs of ``_nw_fwd_plain``."""
    sf, s2 = _raw_support_plain(s, labels)
    score, _ = _scores_plain(_plain_float(q), sf, s2, labels, scale, mode)
    return _softmax_partials_plain(score, labels, n_classes)


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


def _check_prepared(name: str, q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor,
                    mode: str, n_classes: int, qscale: Optional[torch.Tensor], bank_dtypes,
                    query_dtype):
    """The checks of a prepared-bank kernel's operands. Returns the library
    and, for an int8/int4 bank, the query's dequant column (else None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    s, labels, s2 = prep.s, prep.labels, prep.s2
    if s.dtype not in bank_dtypes or q.dtype != query_dtype:
        banks = " or ".join(_BANK_PRECISION[d] for d in bank_dtypes)
        raise ValueError(f"{name}: query {q.dtype} / bank {s.dtype}: need one of {banks} "
                         f"for the bank and a {query_dtype} query")
    if q.dim() != 2 or q.shape[1] != _bank_width(prep) or q.shape[0] == 0:
        raise ValueError(f"query {tuple(q.shape)} does not match bank {tuple(s.shape)}")
    quant = prep.sscale is not None
    if quant != (qscale is not None):
        raise ValueError(f"{name}: qscale goes with an int8/int4 bank, and only with one")
    l2 = mode == "l2"
    if l2 and s2 is None:
        raise ValueError("l2 mode needs the bank's self-norms")
    B = q.shape[0]
    S = s.shape[0]
    qcol = None
    checked = [("bank", s, s.dtype), ("labels", labels, torch.int32),
               ("scale", scale, torch.float32)] + ([("s2", s2, torch.float32)] if l2 else [])
    if quant:
        # The similarity scale rides in the query's dequant column (dot mode).
        qcol = (qscale if l2 else qscale * scale).contiguous()
        checked += [("qscale", qcol, torch.float32), ("sscale", prep.sscale, torch.float32)]
        if qcol.shape != (B,) or prep.sscale.shape != (S,):
            raise ValueError(f"{name}: qscale {tuple(qcol.shape)} / sscale "
                             f"{tuple(prep.sscale.shape)} for B={B}, S={S}")
        if q.data_ptr() % 4 or s.data_ptr() % 4:
            raise ValueError(f"{name}: query and bank must start on a 4-byte boundary")
    for arg, t, dt in checked:
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs contiguous {dt} on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _cuda.load_library()
    if n_classes < 1 or n_classes > lib.nw_prepared_max_classes(q.device.index or 0):
        raise ValueError(f"n_classes={n_classes} is beyond what the kernel's "
                         "shared-memory accumulator holds on this device")
    return lib, qcol


def _partials(n_splits: int, B: int, n_classes: int, device, partials: bool = False):
    """Pass 1's scratch (m, l, acc per split), the output ``(B, C)`` and,
    with ``partials``, the merged statistics ``m, l (B,)``: the six tensors
    (the last two None without ``partials``) and their pointers."""
    f32 = dict(dtype=torch.float32, device=device)
    stats = (torch.empty(B, **f32), torch.empty(B, **f32)) if partials else (None, None)
    bufs = (torch.empty((n_splits, B), **f32), torch.empty((n_splits, B), **f32),
            torch.empty((n_splits, B, n_classes), **f32), torch.empty((B, n_classes), **f32),
            *stats)
    return bufs, tuple(None if t is None else t.data_ptr() for t in bufs)


def _launch_result(bufs, partials: bool):
    """A forward launch's result from ``_partials``' tensors: the log-probs,
    or with ``partials`` ``(m (B, 1), l (B, 1), acc (B, C))``."""
    out, m, l = bufs[3:]
    return (m[:, None], l[:, None], out) if partials else out


def _prepared_launch(name: str, q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor,
                     mode: str, n_classes: int, qscale: Optional[torch.Tensor],
                     bank_dtypes, query_dtype, partials: bool = False):
    """Check a prepared-bank kernel's operands and launch it on the current
    stream: pass 1 writes per-split partials (m, l, acc), pass 2 merges them
    and takes the log, or with ``partials`` returns the merged ``(m, l,
    acc)`` unfinalized. ``qscale`` goes with an int8/int4 bank only."""
    lib, qcol = _check_prepared(name, q, prep, scale, mode, n_classes, qscale, bank_dtypes,
                                query_dtype)
    s, labels, s2 = prep.s, prep.labels, prep.s2
    quant, l2 = qcol is not None, mode == "l2"
    (B, D), S = q.shape, s.shape[0]
    q = q.contiguous()
    n_tiles_q = math.ceil(B / lib.nw_prepared_query_tile())
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, n_splits = _split_rows(S, n_tiles_q, n_sms, lib.nw_prepared_support_tile())
    bufs, ptrs = _partials(n_splits, B, n_classes, q.device, partials)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if quant:
            rc = lib.nw_prepared_quant_forward(
                q.data_ptr(), s.data_ptr(), s2.data_ptr() if l2 else None, labels.data_ptr(),
                qcol.data_ptr(), prep.sscale.data_ptr(), *ptrs, B, S, D, n_classes,
                int(l2), int(s.dtype == torch.uint8), n_splits, rows, int(partials), stream)
        else:
            rc = lib.nw_prepared_forward(
                q.data_ptr(), s.data_ptr(), s2.data_ptr() if l2 else None,
                labels.data_ptr(), scale.data_ptr(), *ptrs, B, S, D, n_classes, int(l2),
                int(s.dtype == torch.bfloat16), n_splits, rows, int(partials), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.nw_prepared_error_string(rc).decode()}"
        )
    return _launch_result(bufs, partials)


def nw_prepared_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K2 (``csrc/nw_prepared.cu``) over an f32 or bf16 bank, ``q``
    in the bank's dtype. Raises on anything the kernel does not take."""
    out = _prepared_launch("nw_prepared_cuda", q, prep, scale, mode, n_classes, qscale,
                           (torch.float32, torch.bfloat16), prep.s.dtype)
    nw_prepared_cuda.launches += 1
    return out


nw_prepared_cuda.launches = 0


def nw_prepared_int8_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K4 (``csrc/nw_prepared.cu``) over an int8 bank: ``q`` the int8
    query ``(B, D_pad)`` and ``qscale`` its scales (``_prepared_query``)."""
    out = _prepared_launch("nw_prepared_int8_cuda", q, prep, scale, mode, n_classes, qscale,
                           (torch.int8,), torch.int8)
    nw_prepared_int8_cuda.launches += 1
    return out


nw_prepared_int8_cuda.launches = 0


def nw_prepared_int4_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K5 (``csrc/nw_prepared.cu``) over an int4 bank (uint8, two
    codes a byte, unpacked on chip): ``q`` the int8 query ``(B, D_pad)``
    and ``qscale`` its scales."""
    out = _prepared_launch("nw_prepared_int4_cuda", q, prep, scale, mode, n_classes, qscale,
                           (torch.uint8,), torch.int8)
    nw_prepared_int4_cuda.launches += 1
    return out


nw_prepared_int4_cuda.launches = 0


def nw_prepared_partials_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 ``partials=True`` (``csrc/nw_prepared.cu``, the unfinalized
    merge): ``(m (B, 1), l (B, 1), acc (B, C))`` over an f32 or bf16 bank,
    ``q`` in the bank's dtype."""
    out = _prepared_launch("nw_prepared_partials_cuda", q, prep, scale, mode, n_classes,
                           qscale, (torch.float32, torch.bfloat16), prep.s.dtype, True)
    nw_prepared_partials_cuda.launches += 1
    return out


nw_prepared_partials_cuda.launches = 0


def nw_prepared_partials_int8_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 ``partials=True``: ``(m, l, acc)`` over an int8 bank, ``q`` the
    int8 query and ``qscale`` its scales."""
    out = _prepared_launch("nw_prepared_partials_int8_cuda", q, prep, scale, mode, n_classes,
                           qscale, (torch.int8,), torch.int8, True)
    nw_prepared_partials_int8_cuda.launches += 1
    return out


nw_prepared_partials_int8_cuda.launches = 0


def nw_prepared_partials_int4_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 ``partials=True``: ``(m, l, acc)`` over an int4 bank, ``q`` the
    int8 query and ``qscale`` its scales."""
    out = _prepared_launch("nw_prepared_partials_int4_cuda", q, prep, scale, mode, n_classes,
                           qscale, (torch.uint8,), torch.int8, True)
    nw_prepared_partials_int4_cuda.launches += 1
    return out


nw_prepared_partials_int4_cuda.launches = 0

# Bank dtype -> the ``bank`` code of nw_prepared_sel_forward.
_SEL_BANK = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}


def _prepared_sel_launch(name: str, q: torch.Tensor, prep: PreparedSupport,
                         scale: torch.Tensor, mode: str, n_classes: int,
                         qscale: Optional[torch.Tensor], tile_sel: torch.Tensor, bank_dtypes,
                         query_dtype, partials: bool = False):
    """Check K6's operands and launch it on the current stream. A 16-query
    tile of the kernel reads one ``tile_sel`` row, so under grouped routing
    each group is padded to whole query tiles with copies of its last query
    (dropped from the output). The split count comes from ``n_sel``, a
    static shape, as K2's comes from the bank's rows; the splits take the
    score tiles in turn, so the union spreads over all of them. Nothing is
    read back from the card. ``partials`` as in ``_prepared_launch``."""
    lib, qcol = _check_prepared(name, q, prep, scale, mode, n_classes, qscale, bank_dtypes,
                                query_dtype)
    tile = lib.nw_prepared_support_tile()
    if prep.block_s is None or prep.block_s % tile:
        raise ValueError(f"{name}: tile_sel needs a bank prepared with block_s")
    if tile_sel.device != q.device:
        raise ValueError(f"{name}: tile_sel on {tile_sel.device}, queries on {q.device}")
    sel, group_b = _sel_rows(tile_sel, q.shape[0])
    n_groups, n_sel = sel.shape
    qt = lib.nw_prepared_query_tile()
    group_pad = _round_up(group_b, qt) if n_groups > 1 else group_b
    if group_pad != group_b:
        pick = (torch.arange(n_groups, device=q.device)[:, None] * group_b
                + torch.arange(group_pad, device=q.device).clamp(max=group_b - 1)).reshape(-1)
        q = q[pick]
        qcol = None if qcol is None else qcol[pick]
    q, sel = q.contiguous(), sel.contiguous()
    B, D = q.shape
    n_query_tiles = math.ceil(B / qt)
    qtiles_per_row = group_pad // qt if n_groups > 1 else n_query_tiles
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, n_splits = _split_rows(n_sel * prep.block_s, n_query_tiles, n_sms, tile)
    bufs, ptrs = _partials(n_splits, B, n_classes, q.device, partials)
    l2 = mode == "l2"
    with torch.cuda.device(q.device):
        rc = lib.nw_prepared_sel_forward(
            q.data_ptr(), prep.s.data_ptr(), prep.s2.data_ptr() if l2 else None,
            prep.labels.data_ptr(), scale.data_ptr(), None if qcol is None else qcol.data_ptr(),
            None if qcol is None else prep.sscale.data_ptr(), sel.data_ptr(), *ptrs, B, D,
            n_classes, int(l2), _SEL_BANK[prep.s.dtype], n_sel, qtiles_per_row,
            prep.labels.shape[0] // prep.block_s, prep.block_s, n_splits, int(partials),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.nw_prepared_error_string(rc).decode()}")
    result = _launch_result(bufs, partials)
    if group_pad != group_b:
        def unpad(t):
            return t.reshape(n_groups, group_pad, -1)[:, :group_b].reshape(n_groups * group_b, -1)

        result = tuple(map(unpad, result)) if partials else unpad(result)
    return result


def nw_prepared_sel_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor], tile_sel: torch.Tensor,
) -> torch.Tensor:
    """Launch K6 (``csrc/nw_prepared.cu``) over the tiles ``tile_sel`` names
    of an f32 or bf16 bank, ``q`` in the bank's dtype."""
    out = _prepared_sel_launch("nw_prepared_sel_cuda", q, prep, scale, mode, n_classes, qscale,
                               tile_sel, (torch.float32, torch.bfloat16), prep.s.dtype)
    nw_prepared_sel_cuda.launches += 1
    return out


nw_prepared_sel_cuda.launches = 0


def nw_prepared_sel_quant_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor], tile_sel: torch.Tensor,
) -> torch.Tensor:
    """Launch K6 (``csrc/nw_prepared.cu``) over the tiles ``tile_sel`` names
    of an int8 or int4 bank: ``q`` the int8 query ``(B, D_pad)`` and
    ``qscale`` its scales (``_prepared_query``)."""
    out = _prepared_sel_launch("nw_prepared_sel_quant_cuda", q, prep, scale, mode, n_classes,
                               qscale, tile_sel, (torch.int8, torch.uint8), torch.int8)
    nw_prepared_sel_quant_cuda.launches += 1
    return out


nw_prepared_sel_quant_cuda.launches = 0


def nw_prepared_sel_partials_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor], tile_sel: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 ``partials=True`` over the tiles ``tile_sel`` names of an f32 or
    bf16 bank: ``(m, l, acc)`` unfinalized; a query whose tiles hold no
    valid row gets ``(_NEG_INF, 0, 0)``."""
    out = _prepared_sel_launch("nw_prepared_sel_partials_cuda", q, prep, scale, mode,
                               n_classes, qscale, tile_sel, (torch.float32, torch.bfloat16),
                               prep.s.dtype, True)
    nw_prepared_sel_partials_cuda.launches += 1
    return out


nw_prepared_sel_partials_cuda.launches = 0


def nw_prepared_sel_partials_quant_cuda(
    q: torch.Tensor, prep: PreparedSupport, scale: torch.Tensor, mode: str,
    n_classes: int, qscale: Optional[torch.Tensor], tile_sel: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 ``partials=True`` over the tiles ``tile_sel`` names of an int8 or
    int4 bank: ``q`` the int8 query and ``qscale`` its scales."""
    out = _prepared_sel_launch("nw_prepared_sel_partials_quant_cuda", q, prep, scale, mode,
                               n_classes, qscale, tile_sel, (torch.int8, torch.uint8),
                               torch.int8, True)
    nw_prepared_sel_partials_quant_cuda.launches += 1
    return out


nw_prepared_sel_partials_quant_cuda.launches = 0


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


def _fwd_launch(name: str, q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor,
                scale: torch.Tensor, mode: str, n_classes: int, partials: bool):
    """Check K1's operands and launch it on the current stream: pass 1 over
    (query tiles x support splits) writes partials, pass 2 merges them into
    ``(out (B, C), m (B, 1), l (B, 1))``, ``out`` the log-probs, or with
    ``partials`` the label sums unfinalized."""
    _check_raw(name, q, s, [("labels", labels, torch.int32), ("scale", scale, torch.float32)])
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
                int(partials), torch.cuda.current_stream(q.device).cuda_stream)
    return out, m[:, None], l[:, None]


def nw_fwd_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 (``csrc/nw_fused.cu``): ``(out (B, C), m (B, 1), l (B,
    1))``, the log-probs and the softmax statistics the backward needs."""
    out = _fwd_launch("nw_fwd_cuda", q, s, labels, scale, mode, n_classes, False)
    nw_fwd_cuda.launches += 1
    return out


nw_fwd_cuda.launches = 0


def nw_fwd_partials_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 ``partials=True`` (``csrc/nw_fused.cu``, the unfinalized
    merge): ``(m (B, 1), l (B, 1), acc (B, C))`` from raw features."""
    acc, m, l = _fwd_launch("nw_fwd_partials_cuda", q, s, labels, scale, mode, n_classes, True)
    nw_fwd_partials_cuda.launches += 1
    return m, l, acc


nw_fwd_partials_cuda.launches = 0


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
    serving path (K2, K4, K5). ``precision='bf16'`` casts both feature sets
    to bf16 before the kernel normalization; products and softmax stay f32
    and the gradients come back through the cast. ``'int8'`` and ``'int4'``
    quantize prepared banks only: on raw features they run at f32, as the
    JAX package's raw path does (``pallas_nw.py:2073-2077``)."""
    if isinstance(sfeat, PreparedSupport):
        if n_classes is None:
            raise ValueError("n_classes is required with a PreparedSupport")
        if support_mask is not None:
            raise ValueError("support_mask must be baked in at prepare_support time "
                             "(the prepared bank's labels already encode the mask)")
        bank = _BANK_PRECISION[sfeat.s.dtype]
        if precision is not None and precision != bank:
            raise ValueError(f"precision={precision!r} but the prepared bank is {bank} "
                             "— pass precision= to prepare_support instead")
        return nw_fused_from_prepared(qfeat, sfeat, n_classes, kernel=kernel,
                                      kernel_params=kernel_params)
    if sy is None or n_classes is None:
        raise ValueError("the raw fused path needs the support labels and n_classes")
    precision = precision or "f32"
    if precision not in _PRECISIONS and precision not in _QUANT:
        raise ValueError(f"unknown precision {precision!r}")
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
    tile_sel: Optional[torch.Tensor] = None,
    partials: bool = False,
):
    """Fused NW log-probs ``(B, C)`` over a ``prepare_support`` bank.
    Inference only. The query is normalized in f32, then cast to the
    bank's dtype, or quantized for an int8/int4 bank; the bank's dtype
    picks the kernel (K2, K4 or K5).

    ``tile_sel`` (a bank prepared with ``block_s``) streams only the listed
    tiles (K6; ``-1`` = an empty slot): int32 ``(n_sel,)`` for the whole
    batch, or ``(n_groups, n_sel)`` with one row per ``B / n_groups``
    consecutive queries (grouped routing, ``ops/ivf.py``).

    ``partials=True`` returns the online softmax's statistics ``(m (B, 1),
    l (B, 1), acc (B, C))`` unfinalized, for a merge across support shards
    (``parallel/sharded_bank.py``): ``m`` the largest score, ``l`` and
    ``acc`` relative to it; a query that meets no valid row gets
    ``(_NEG_INF, 0, 0)``."""
    q, scale, mode, qscale = _prepared_query(qfeat, prepared, kernel, kernel_params)
    if tile_sel is not None:
        if q.device.type == "cpu":
            return _nw_prepared_sel_plain(q, prepared, scale, mode, n_classes, qscale, tile_sel,
                                          partials)
        if partials:
            wrapper = (nw_prepared_sel_partials_cuda if qscale is None
                       else nw_prepared_sel_partials_quant_cuda)
        else:
            wrapper = nw_prepared_sel_cuda if qscale is None else nw_prepared_sel_quant_cuda
        return wrapper(q, prepared, scale, mode, n_classes, qscale, tile_sel)
    if q.device.type == "cpu":
        return _nw_prepared_plain(q, prepared, scale, mode, n_classes, qscale, partials)
    if partials:
        wrapper = {torch.int8: nw_prepared_partials_int8_cuda,
                   torch.uint8: nw_prepared_partials_int4_cuda}.get(prepared.s.dtype,
                                                                    nw_prepared_partials_cuda)
    else:
        wrapper = {torch.int8: nw_prepared_int8_cuda,
                   torch.uint8: nw_prepared_int4_cuda}.get(prepared.s.dtype, nw_prepared_cuda)
    return wrapper(q, prepared, scale, mode, n_classes, qscale)


@torch.no_grad()
def nw_fused_partials(
    qfeat: torch.Tensor,
    sfeat: torch.Tensor,
    sy,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    support_mask: Optional[torch.Tensor] = None,
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw fused pass unfinalized (K1 ``partials=True``, the JAX
    package's ``nw_fused_partials``): ``(m (B, 1), l (B, 1), acc (B, C))``
    of one support shard, as ``nw_fused_from_prepared(partials=True)``
    gives them. Masked rows (``support_mask == 0``) may hold anything and
    score ``_NEG_INF``. ``precision='bf16'`` casts both feature sets before
    the kernel normalization. Inference only: nothing is recorded for
    autograd."""
    if precision not in _PRECISIONS:
        raise ValueError(f"nw_fused_partials runs at f32 or bf16, got {precision!r}")
    labels = torch.as_tensor(sy, device=sfeat.device).to(torch.int32)
    if support_mask is not None:
        valid = torch.as_tensor(support_mask, device=sfeat.device) > 0
        labels = torch.where(valid, labels, torch.full_like(labels, -1))
        sfeat = torch.where(valid[:, None], sfeat, torch.zeros((), dtype=sfeat.dtype,
                                                               device=sfeat.device))
    qfeat, sfeat = qfeat.to(_PRECISIONS[precision]), sfeat.to(_PRECISIONS[precision])
    mode, scale, qn, sn = _resolve_mode(kernel, kernel_params or {}, qfeat, sfeat)
    args = (qn.to(sn.dtype).contiguous(), sn.contiguous(), labels.contiguous(), scale, mode,
            n_classes)
    if qn.device.type == "cpu":
        return _nw_fwd_partials_plain(*args)
    return nw_fwd_partials_cuda(*args)
