"""Fused NW head: the raw differentiable path (training) and the prepared
serving path.

Port of ``nwhead_tpu/ops/pallas_nw.py``: ``prepare_support``,
``_resolve_mode``, ``nw_fused_log_probs`` with its custom VJP, and
``nw_fused_from_prepared``. It holds no Pallas: the kernels are CUDA C++
for Hopper, built and loaded by ``ops/_cuda.py``:

* K1 ``csrc/nw_prepared.cu`` ``nw_raw_forward`` (TPU ``_nw_fwd_kernel``):
  raw features in, log-probs and the softmax statistics ``(m, l)`` out, on
  the prepared banks' tensor-core pass 1 (``nw_prepared_tc_kernel`` over
  raw rows, the same query tile and split rule), ``|q|^2`` and ``|s|^2``
  from the tensor cores by ``q.s``'s own route, so that a query that is
  also a support row scores exactly 0;
* K3 ``csrc/nw_fused.cu`` ``nw_fused_bwd_dq`` / ``nw_fused_bwd_ds`` (TPU
  ``_nw_bwd_dq_kernel`` / ``_nw_bwd_ds_kernel``): the backward, recomputing
  the scores from ``(m, l)``; dq on the tensor cores (``nw_raw_dq_tc_kernel``:
  K1's score route, then ``sum_j t_bj s_j`` on 3xTF32, its query tile from
  ``_dq_query_tile``) and ds too (``nw_raw_ds_tc_kernel``: a thread-block
  cluster on each 64 support rows, its blocks' partial score tiles added
  in rank order through distributed shared memory, then ``t^T q`` on
  3xTF32; its query tile, cluster and query group from ``_ds_plan``);
* K2 ``csrc/nw_prepared.cu`` ``nw_prepared_forward`` (TPU
  ``_nw_prepared_kernel``): the forward over a bank normalized and packed
  once by ``prepare_support``, f32 or bf16, its scores on the tensor cores
  (``nw_prepared_tc_kernel``, whose query tile and split count
  ``_tc_query_tile`` and ``_tc_splits`` choose);
* K4 and K5 ``csrc/nw_prepared.cu`` ``nw_prepared_quant_forward`` (TPU
  ``_nw_prepared_kernel`` with ``quant=True`` / ``quant4=True``): the same
  kernel over an int8 bank, or an int4 bank of two codes a byte, against a
  query quantized per row; exact int32 dot products on s8 tensor cores,
  dequantized by the query's and the row's scales; an int4 bank takes the
  query's columns in its k order (``_int4_query``);
* K6 ``csrc/nw_prepared.cu`` ``nw_prepared_sel_forward`` (TPU
  ``_nw_prepared_kernel`` with ``tile_sel``): K2/K4/K5's very kernel over
  only the bank tiles a list names (IVF-pruned serving, ``ops/ivf.py``),
  one list for the batch or one per query group.

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

A prepared bank is edited without preparing it again (``NWNet.add_support``
/ ``remove_support``): ``prepare_for_concat`` prepares only new rows and
``concat_prepared`` appends them (O(new) work and one copy of the bank);
``mask_prepared_rows`` tombstones rows by their labels (O(removed)).

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


def inverse_order(order: np.ndarray) -> np.ndarray:
    """The inverse of ``prepare_support``'s ``order``: input row ``i`` is
    stored at prepared row ``inverse_order(order)[i]``."""
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order), dtype=np.int64)
    return inv


def prepare_for_concat(
    sfeat: torch.Tensor,
    sy,
    n_classes: int,
    like: PreparedSupport,
    *,
    kernel: str = "euclidean",
    precision: str = "f32",
    support_mask: Optional[torch.Tensor] = None,
    return_order: bool = False,
):
    """Prepare new rows so that ``concat_prepared`` takes them after
    ``like`` (``pallas_nw.py:414``). An untiled ``like`` needs nothing
    more than ``prepare_support``. A tiled one (an IVF bank or shard) has
    the new rows padded with masked rows to a multiple of ``like.block_s``
    and prepared at that tile size: ``prepare_support`` would otherwise
    shrink the tile to ``round_up(S, 128)`` for a small add, and the concat
    would be refused. Pass the ``kernel`` and ``precision`` ``like`` was
    built with; ``concat_prepared`` checks the dtype and widths, not the
    kernel."""
    n = int(sfeat.shape[0])
    if n == 0:
        raise ValueError("prepare_for_concat needs at least one row")
    block_s = like.block_s
    if block_s is not None:
        pad = _round_up(n, block_s) - n
        sy = np.concatenate([np.asarray(torch.as_tensor(sy).cpu()), np.zeros(pad, np.int64)])
        mask = torch.ones(n, dtype=torch.float32) if support_mask is None \
            else torch.as_tensor(support_mask).to("cpu", torch.float32)
        support_mask = torch.nn.functional.pad(mask, (0, pad))
        sfeat = torch.nn.functional.pad(sfeat, (0, 0, 0, pad))
    return prepare_support(sfeat, sy, n_classes, kernel=kernel, support_mask=support_mask,
                           precision=precision, block_s=block_s, return_order=return_order)


def concat_prepared(preps) -> PreparedSupport:
    """One prepared bank of several, by concatenating their fields
    (``pallas_nw.py:452``): every field is per row, and every int8/int4 row
    is quantized on its own, so the result holds the same rows, codes and
    scales as one bank prepared whole, in another order (the head does
    not depend on the order). Banks of another dtype, feature width or
    tile size (a tiled bank beside an untiled one too), or with ``s2`` or
    ``sscale`` where the first has none or the reverse, raise
    ``ValueError``. JAX's class windows, which the port does not have, are
    the only step left out: no concat here loses them, so none rebuilds."""
    preps = list(preps)
    if not preps:
        raise ValueError("concat_prepared needs at least one bank")
    ref = preps[0]
    for p in preps[1:]:
        if p.s.dtype != ref.s.dtype:
            raise ValueError(f"precision mismatch: {p.s.dtype} vs {ref.s.dtype}")
        if p.s.shape[1] != ref.s.shape[1]:
            raise ValueError(f"feature width mismatch: {p.s.shape[1]} vs {ref.s.shape[1]}")
        if p.block_s != ref.block_s:
            raise ValueError(f"tile size (block_s) mismatch: {p.block_s} vs {ref.block_s}")
        for name in ("s2", "sscale"):
            if (getattr(p, name) is None) != (getattr(ref, name) is None):
                raise ValueError(f"{name} presence mismatch (different kernel mode or precision)")
    if len(preps) == 1:
        return ref

    def cat(field):
        return None if getattr(ref, field) is None else torch.cat([getattr(p, field)
                                                                    for p in preps])

    return PreparedSupport(s=cat("s"), s2=cat("s2"), labels=cat("labels"), sscale=cat("sscale"),
                           block_s=ref.block_s)


def mask_prepared_rows(prep: PreparedSupport, rows) -> PreparedSupport:
    """Tombstone prepared rows (``pallas_nw.py:537``): their labels become
    -1 and, in l2 mode, their self-norms ``_MASK_S2``, which is how
    ``prepare_support`` masks a row. Pass 1 drops every row with a negative
    label in every mode, so features and scales stay where they are. A
    new bank is returned, with new ``labels`` (and ``s2``); ``prep`` is
    left as it was, since serving callables and a shard's copies may share
    it. ``rows`` are prepared positions (``prepare_support(...,
    return_order=True)`` gives them: it class-sorts when C > 128); an empty
    list returns ``prep`` itself, a row outside the bank raises
    ``IndexError``. The device work is one copy of the labels (and
    self-norms)."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return prep
    n = prep.labels.shape[0]
    if rows.min() < 0 or rows.max() >= n:
        raise IndexError(f"prepared-row index out of range for {n} rows")
    idx = torch.as_tensor(rows, device=prep.labels.device)
    s2 = None if prep.s2 is None else prep.s2.index_fill(0, idx, _MASK_S2)
    return prep._replace(labels=prep.labels.index_fill(0, idx, -1), s2=s2)


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


def _int4_query(q8: torch.Tensor) -> torch.Tensor:
    """An int8 query ``(B, D_pad)`` in the int4 kernel's k order: a 128-byte
    query slice pairs with 64 packed bytes of each bank row, so for each
    run of 16 packed bytes come their 16 low-nibble features (``j``), then
    their 16 high-nibble ones (``j + D_pad / 2``); a last, short run is
    filled with zeros. ``(B, D_pad rounded up to 32)``, by reshapes on the
    query's device (no index table to copy over)."""
    B, width = q8.shape
    half = width // 2
    halves = q8.reshape(B, 2, half)
    if half % 16:
        halves = torch.nn.functional.pad(halves, (0, _round_up(half, 16) - half))
    return halves.reshape(B, 2, -1, 16).transpose(1, 2).reshape(B, -1)


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


def _quant_dots_plain(q8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The integer dot products ``(B, S)`` of int8 queries and bank codes, as
    f64: exact, since every partial sum is an integer below 2^53."""
    return torch.matmul(q8.to(torch.float64), codes.to(torch.float64).T)


def _quant_scores_plain(q8, qscale, prep, scale, mode):
    """K4/K5's score matrix ``(B, S)``, masked rows ``_NEG_INF``: the int32
    dot product (``_quant_dots_plain``, exact), then ``dot * qcol * sscale``
    in f32 with ``qcol = qscale`` (l2) or ``qscale * scale`` (dot: the
    similarity scale folded into the query's column,
    ``pallas_nw.py:1334-1344``). l2: ``-sqrt(max(q2 - 2 dot + s2, 0))``
    with ``q2`` the dequantized query's norm."""
    dot_i = _quant_dots_plain(q8, bank_codes(prep))
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


# The tensor-core pass 1 of K2, K4, K5 and K6, every prepared bank, and of
# K1 over raw rows (``csrc/nw_pass1.cuh``: ``nw_prepared_tc_kernel``);
# these mirror its constants and ``tc_smem_bytes``.
_TC_QUERY_TILES = (32, 16, 8)  # queries a block, the largest that fits first
_TC_SUPPORT_TILE = 64
_TC_STAGES = 3  # slices in each scoring group's ring
_TC_ROW_BYTES = 128
_TC_ALIGN = 1024
_TC_LIST_CAP = 512
H100_SMEM_OPTIN = 232_448  # shared memory a block may opt in to on an H100 (sm_90)


def _tc_stage_bytes(qb: int) -> int:
    """One slice of a ring (``tc_stage_bytes``): query rows, at least 16,
    and 64 support rows of 128 bytes, the tile's labels and self-norms,
    padded to 1 KB."""
    return (max(qb, 16) + _TC_SUPPORT_TILE) * _TC_ROW_BYTES + _TC_ALIGN


def _tc_smem_bytes(qb: int, n_classes: int, sel: bool, stages: int = _TC_STAGES) -> int:
    """Dynamic shared memory of one tensor-core pass-1 block: alignment
    slack; a ring of ``stages`` slices for each of its two scoring groups;
    each group's score tile (two at ``qb <= 16``); ``|q|^2`` and the
    running ``(m, l)``; K6's tile list; the rings' full and empty barriers;
    ``acc[qb][C]``."""
    scores = 2 * (2 if qb <= 16 else 1) * qb * (_TC_SUPPORT_TILE + 4)
    return (_TC_ALIGN + 2 * stages * _tc_stage_bytes(qb) + 4 * (scores + 3 * 32)
            + (4 * (_TC_LIST_CAP + 4) if sel else 0) + 32 * stages + 4 * qb * n_classes)


def _tc_query_tile(queries: int, n_classes: int, sel: bool, smem_optin: int) -> int:
    """The tensor-core pass 1's query tile: the largest of 32, 16 and 8
    whose block fits ``smem_optin`` bytes, and no larger than the power of
    two that holds ``queries`` (the batch, or a routing group): 32 at the
    CUB bank's C = 200 and the million-row bank's C = 1,000."""
    cap = max(8, 1 << max(0, queries - 1).bit_length())
    for qb in _TC_QUERY_TILES:
        if qb <= cap and _tc_smem_bytes(qb, n_classes, sel) <= smem_optin:
            return qb
    raise ValueError(f"n_classes={n_classes} is beyond what the kernel's shared-memory "
                     "accumulator holds on this device")


def _tc_splits(n_rows: int, n_query_tiles: int, n_sms: int) -> Tuple[int, int]:
    """Support rows per split and the split count of the tensor-core pass
    1, a pure function of static shapes: enough (query tile x split) blocks
    to fill the SMs once (one block an SM, by its launch bounds; it keeps
    its own loads in flight, so it needs no other block to cover its
    waits), and no more, since each split costs ``B x C x 4`` bytes of
    partials written and read back (pass 2 reads them at about 0.4 TB/s on
    an H100). Every split holds whole 64-row tiles, none is empty. K6
    passes its slot-order rows, ``n_sel x block_s``."""
    tile = _TC_SUPPORT_TILE
    want = max(1, math.ceil(n_sms / n_query_tiles))
    rows = _round_up(max(tile, math.ceil(n_rows / want)), tile)
    return rows, math.ceil(n_rows / rows)


# K3's dq pass 1 (``csrc/nw_fused.cu``: ``nw_raw_dq_tc_kernel``): its ring
# of slices, each tile streamed twice (scores, then ``t s``).
_DQ_STAGES = 6


def _dq_smem_bytes(qb: int, D: int) -> int:
    """Dynamic shared memory of one dq block (``dq_tc_smem_bytes``):
    alignment slack; the ring (query rows, at least 16, and 64 support rows
    of 128 bytes, the tile's labels and self-norms, padded to 1 KB); the
    score tile (two at ``qb <= 16``); ``t`` (at least 16 rows); the
    queries' ``|q|^2`` halves, ``m_safe``, ``max(l, 1e-30)``, ``r`` and
    ``sum_j t``; the ring's barriers; ``sum_j t s_j``, ``qb x (D + 8)``."""
    rows = max(qb, 16)
    stage = (rows + _TC_SUPPORT_TILE) * _TC_ROW_BYTES + _TC_ALIGN
    stride = _TC_SUPPORT_TILE + 4
    floats = (2 if qb <= 16 else 1) * qb * stride + rows * stride + 5 * 32
    return _TC_ALIGN + _DQ_STAGES * stage + 4 * floats + 16 * _DQ_STAGES + 4 * qb * (D + 8)


def _dq_query_tile(queries: int, D: int, smem_optin: int) -> int:
    """The dq pass's query tile: the largest of 32, 16 and 8 whose block
    fits ``smem_optin`` bytes with ``D`` features, and no larger than the
    power of two that holds ``queries`` (8 at the training episode's B = 8,
    32 at B = 64)."""
    cap = max(8, 1 << max(0, queries - 1).bit_length())
    for qb in _TC_QUERY_TILES:
        if qb <= cap and _dq_smem_bytes(qb, D) <= smem_optin:
            return qb
    raise ValueError(f"D={D} is beyond the dq pass's shared-memory accumulator")


# K3's ds pass (``csrc/nw_fused.cu``: ``nw_raw_ds_tc_kernel``): a cluster
# of blocks on each 64 support rows, t for a query group in shared memory.
_DS_STAGES = 6
_DS_CHUNK = 64  # query rows a stage of t^T q
_DS_T_STRIDE = _TC_SUPPORT_TILE + 8
_DS_CLUSTERS = (4, 2, 1)


def _ds_smem_bytes(qb: int, cluster: int, group: int) -> int:
    """Dynamic shared memory of one ds block (``ds_tc_smem_bytes``):
    alignment slack; the ring (query rows, at least 16, and 64 support rows
    of 128 bytes, padded to 1 KB, or 64 query rows and 64 support rows for
    ``t^T q``, whichever is larger) and its barriers with the two exchange
    barriers; the partial score tile(s) (two at ``qb <= 16``) and
    self-norms, one set, or in a cluster one from each block for each of
    two query tiles; t, ``group`` rows in 32-row steps of 64 + 8 floats;
    ``sum_b t`` and the rows' ``|s|^2``; the tile's labels."""
    stage = max((max(qb, 16) + _TC_SUPPORT_TILE) * _TC_ROW_BYTES + _TC_ALIGN,
                (_DS_CHUNK + _TC_SUPPORT_TILE) * _TC_ROW_BYTES)
    part = (2 if qb <= 16 else 1) * qb * (_TC_SUPPORT_TILE + 4) + 2 * _TC_SUPPORT_TILE + 32
    inbox = 2 * cluster if cluster > 1 else 1
    floats = inbox * part + _round_up(group, 32) * _DS_T_STRIDE + 2 * _TC_SUPPORT_TILE
    return (_TC_ALIGN + _DS_STAGES * stage + 8 * (2 * _DS_STAGES + 2) + 4 * floats
            + 4 * _TC_SUPPORT_TILE)


def _ds_plan(queries: int, n_rows: int, D: int, elem: int, smem_optin: int,
             n_sms: int) -> Tuple[int, int, int]:
    """The ds pass's plan, a pure function of static shapes: ``(qb,
    cluster, group)``. The query tile is 8 for up to 8 queries, else 16
    (at 32 queries the f32 kernel spills 372 bytes and ran 28% slower at
    B = 64 on an H100); each 64-row support tile gets the
    largest cluster of 4, 2 or 1 blocks that keeps every block's share of
    the feature slices (128 bytes each) non-empty and the whole grid
    within one wave of ``n_sms`` (4 at the training episode's 19 tiles, 1
    at B = 64 over S = 5,994's 94); ``group`` is ``queries`` where its t
    fits the block, else the largest multiple of 64 that does (the batch
    then runs in groups, with no cap). D is held to dq's cap, the
    backward's (``nw_fused_dq_max_features``): past it the plan raises."""
    cap = (smem_optin - _dq_smem_bytes(8, 0)) // (4 * 8)
    if D > cap:
        raise ValueError(f"D={D} is beyond the backward's cap of {cap} features "
                         "(dq's shared-memory accumulator)")
    qb = 8 if queries <= 8 else 16
    slices = math.ceil(D * elem / _TC_ROW_BYTES)
    tiles = math.ceil(n_rows / _TC_SUPPORT_TILE)
    cluster = next(c for c in _DS_CLUSTERS if c == 1 or (c <= slices and tiles * c <= n_sms))
    if _ds_smem_bytes(qb, cluster, queries) <= smem_optin:
        return qb, cluster, queries
    fixed = _ds_smem_bytes(qb, cluster, 0)
    return qb, cluster, (smem_optin - fixed) // (4 * _DS_T_STRIDE) // _DS_CHUNK * _DS_CHUNK


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
    for arg, t, dt in checked:
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs contiguous {dt} on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _cuda.load_library()
    if n_classes < 1 or n_classes > lib.nw_prepared_max_classes(q.device.index or 0):
        raise ValueError(f"n_classes={n_classes} is beyond what the kernel's "
                         "shared-memory accumulator holds on this device")
    return lib, qcol


def _smem_optin(lib, device) -> int:
    """The shared memory a block may opt in to on the card."""
    return lib.nw_prepared_smem_optin(
        device.index if device.index is not None else torch.cuda.current_device())


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
    acc)`` unfinalized. ``qscale`` goes with an int8/int4 bank only. Every
    bank's pass 1 is the tensor-core kernel (``_tc_query_tile``,
    ``_tc_splits``); an int4 bank takes the query in its k order
    (``_int4_query``)."""
    lib, qcol = _check_prepared(name, q, prep, scale, mode, n_classes, qscale, bank_dtypes,
                                query_dtype)
    s, labels, s2 = prep.s, prep.labels, prep.s2
    quant, l2 = qcol is not None, mode == "l2"
    (B, D), S = q.shape, s.shape[0]
    int4 = s.dtype == torch.uint8
    q = _int4_query(q) if int4 else q.contiguous()
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    qb = _tc_query_tile(B, n_classes, False, _smem_optin(lib, q.device))
    rows, n_splits = _tc_splits(S, math.ceil(B / qb), n_sms)
    bufs, ptrs = _partials(n_splits, B, n_classes, q.device, partials)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if quant:
            rc = lib.nw_prepared_quant_forward(
                q.data_ptr(), s.data_ptr(), s2.data_ptr() if l2 else None, labels.data_ptr(),
                qcol.data_ptr(), prep.sscale.data_ptr(), *ptrs, B, S, D, n_classes,
                int(l2), int(int4), n_splits, rows, qb, int(partials), stream)
        else:
            rc = lib.nw_prepared_forward(
                q.data_ptr(), s.data_ptr(), s2.data_ptr() if l2 else None,
                labels.data_ptr(), scale.data_ptr(), *ptrs, B, S, D, n_classes, int(l2),
                int(s.dtype == torch.bfloat16), n_splits, rows, qb, int(partials), stream)
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
    """Check K6's operands and launch it on the current stream. A query
    tile of the kernel (``_tc_query_tile``'s, no larger than a routing
    group) reads one ``tile_sel`` row, so under grouped routing each group
    is padded to whole query tiles with copies of its last query (dropped
    from the output). The split count comes from ``n_sel``, a static shape,
    as K2's comes from the bank's rows; the splits take the score tiles in
    turn, so the union spreads over all of them. Nothing is read back from
    the card. ``partials`` as in ``_prepared_launch``."""
    lib, qcol = _check_prepared(name, q, prep, scale, mode, n_classes, qscale, bank_dtypes,
                                query_dtype)
    tile = lib.nw_prepared_support_tile()
    if prep.block_s is None or prep.block_s % tile:
        raise ValueError(f"{name}: tile_sel needs a bank prepared with block_s")
    if tile_sel.device != q.device:
        raise ValueError(f"{name}: tile_sel on {tile_sel.device}, queries on {q.device}")
    sel, group_b = _sel_rows(tile_sel, q.shape[0])
    n_groups, n_sel = sel.shape
    qt = _tc_query_tile(group_b, n_classes, True, _smem_optin(lib, q.device))
    group_pad = _round_up(group_b, qt) if n_groups > 1 else group_b
    if group_pad != group_b:
        pick = (torch.arange(n_groups, device=q.device)[:, None] * group_b
                + torch.arange(group_pad, device=q.device).clamp(max=group_b - 1)).reshape(-1)
        q = q[pick]
        qcol = None if qcol is None else qcol[pick]
    B, D = q.shape
    q = _int4_query(q) if prep.s.dtype == torch.uint8 else q.contiguous()
    sel = sel.contiguous()
    n_query_tiles = math.ceil(B / qt)
    qtiles_per_row = group_pad // qt if n_groups > 1 else n_query_tiles
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, n_splits = _tc_splits(n_sel * prep.block_s, n_query_tiles, n_sms)
    bufs, ptrs = _partials(n_splits, B, n_classes, q.device, partials)
    l2 = mode == "l2"
    with torch.cuda.device(q.device):
        rc = lib.nw_prepared_sel_forward(
            q.data_ptr(), prep.s.data_ptr(), prep.s2.data_ptr() if l2 else None,
            prep.labels.data_ptr(), scale.data_ptr(), None if qcol is None else qcol.data_ptr(),
            None if qcol is None else prep.sscale.data_ptr(), sel.data_ptr(), *ptrs, B, D,
            n_classes, int(l2), _SEL_BANK[prep.s.dtype], n_sel, qtiles_per_row,
            prep.labels.shape[0] // prep.block_s, prep.block_s, n_splits, qt, int(partials),
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


def _fwd_launch(name: str, q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor,
                scale: torch.Tensor, mode: str, n_classes: int, partials: bool):
    """Check K1's operands and launch it on the current stream: the
    tensor-core pass 1 over raw rows (``_tc_query_tile``, ``_tc_splits``)
    writes per-split partials, pass 2 merges them into ``(out (B, C), m (B,
    1), l (B, 1))``, ``out`` the log-probs, or with ``partials`` the label
    sums unfinalized."""
    _check_raw(name, q, s, [("labels", labels, torch.int32), ("scale", scale, torch.float32)])
    lib = _cuda.load_library()
    if n_classes < 1 or n_classes > lib.nw_prepared_max_classes(q.device.index or 0):
        raise ValueError(f"n_classes={n_classes} is beyond what the kernel's "
                         "shared-memory accumulator holds on this device")
    (B, D), S = q.shape, s.shape[0]
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    qb = _tc_query_tile(B, n_classes, False, _smem_optin(lib, q.device))
    rows, n_splits = _tc_splits(S, math.ceil(B / qb), n_sms)
    bufs, ptrs = _partials(n_splits, B, n_classes, q.device, True)
    with torch.cuda.device(q.device):
        rc = lib.nw_raw_forward(
            q.data_ptr(), s.data_ptr(), labels.data_ptr(), scale.data_ptr(), *ptrs, B, S, D,
            n_classes, int(mode == "l2"), int(s.dtype == torch.bfloat16), n_splits, rows, qb,
            int(partials), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.nw_prepared_error_string(rc).decode()}")
    out, m, l = bufs[3:]
    return out, m[:, None], l[:, None]


def nw_fwd_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 (``csrc/nw_prepared.cu``, raw rows): ``(out (B, C), m (B,
    1), l (B, 1))``, the log-probs and the softmax statistics the backward
    needs."""
    out = _fwd_launch("nw_fwd_cuda", q, s, labels, scale, mode, n_classes, False)
    nw_fwd_cuda.launches += 1
    return out


nw_fwd_cuda.launches = 0


def nw_fwd_partials_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 ``partials=True`` (``csrc/nw_prepared.cu``, the unfinalized
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
    (query tiles x support splits) on the tensor cores (``_dq_query_tile``,
    ``_tc_splits``), then their sum in a fixed order. Returns ``dq (B, D)``
    in ``q``'s dtype."""
    per_query = _bwd_tensors(q, u, r, m, l, n_classes)
    _check_raw("nw_bwd_dq_cuda", q, s, [("labels", labels, torch.int32),
                                        ("scale", scale, torch.float32), *per_query])
    lib = _cuda.load_library("nw_fused")
    (B, D), S = q.shape, s.shape[0]
    if D > lib.nw_fused_dq_max_features(q.device.index or 0):
        raise ValueError(f"D={D} is beyond the dq pass's shared-memory accumulator")
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    qb = _dq_query_tile(B, D, _smem_optin(_cuda.load_library(), q.device))
    rows, n_splits = _tc_splits(S, math.ceil(B / qb), n_sms)
    ts = torch.empty((n_splits, B, D), dtype=torch.float32, device=q.device)
    tsum = torch.empty((n_splits, B), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch(lib, "nw_fused_bwd_dq", q.data_ptr(), s.data_ptr(), labels.data_ptr(),
                *(t.data_ptr() for _, t, _ in per_query), scale.data_ptr(), ts.data_ptr(),
                tsum.data_ptr(), dq.data_ptr(), B, S, D, n_classes, int(mode == "l2"),
                int(s.dtype == torch.bfloat16), n_splits, rows, qb,
                torch.cuda.current_stream(q.device).cuda_stream)
    nw_bwd_dq_cuda.launches += 1
    return dq


nw_bwd_dq_cuda.launches = 0


def _ds_launch(q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, u: torch.Tensor,
               r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, scale: torch.Tensor,
               mode: str, n_classes: int, plan: Optional[Tuple[int, int, int]] = None):
    """Check K3 ds's operands and launch it on the current stream, with
    ``_ds_plan``'s plan or the given ``(qb, cluster, group)``. Returns
    ``ds (S, D)`` in ``s``'s dtype."""
    per_query = _bwd_tensors(q, u, r, m, l, n_classes)
    _check_raw("nw_bwd_ds_cuda", q, s, [("labels", labels, torch.int32),
                                        ("scale", scale, torch.float32), *per_query])
    lib = _cuda.load_library("nw_fused")
    (B, D), S = q.shape, s.shape[0]
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    qb, cluster, group = plan or _ds_plan(B, S, D, s.element_size(),
                                          _smem_optin(_cuda.load_library(), q.device), n_sms)
    scratch = (torch.empty((S, D), dtype=torch.float32, device=q.device) if group < B
               else None)
    ds = torch.empty_like(s)
    with torch.cuda.device(q.device):
        _launch(lib, "nw_fused_bwd_ds", q.data_ptr(), s.data_ptr(), labels.data_ptr(),
                *(t.data_ptr() for _, t, _ in per_query), scale.data_ptr(),
                None if scratch is None else scratch.data_ptr(), ds.data_ptr(), B, S, D,
                n_classes, int(mode == "l2"), int(s.dtype == torch.bfloat16), qb, cluster, group,
                torch.cuda.current_stream(q.device).cuda_stream)
    return ds


def nw_bwd_ds_cuda(
    q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor, u: torch.Tensor,
    r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, scale: torch.Tensor,
    mode: str, n_classes: int,
) -> torch.Tensor:
    """Launch K3's ds pass (``csrc/nw_fused.cu``): on the tensor cores, a
    cluster of blocks on each 64 support rows by ``_ds_plan``, each block
    scoring its share of the feature slices of every query tile, then t^T
    q over its features. Returns ``ds (S, D)`` in ``s``'s dtype."""
    ds = _ds_launch(q, s, labels, u, r, m, l, scale, mode, n_classes)
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
    ``(_NEG_INF, 0, 0)``.

    Every kernel but K6 ``partials`` runs through its custom op
    (``ops/library.py``): the plain version on the CPU, the kernel on a
    card, and a shape for ``torch.export``."""
    from nwhead_tpu_torch.ops import library as L

    q, scale, mode, qscale = _prepared_query(qfeat, prepared, kernel, kernel_params)
    p = prepared
    if tile_sel is not None:
        if partials:  # the host-routed sharded predict's, not a serving op
            if q.device.type == "cpu":
                return _nw_prepared_sel_plain(q, p, scale, mode, n_classes, qscale, tile_sel,
                                              True)
            wrapper = (nw_prepared_sel_partials_cuda if qscale is None
                       else nw_prepared_sel_partials_quant_cuda)
            return wrapper(q, p, scale, mode, n_classes, qscale, tile_sel)
        if p.block_s is None:
            raise ValueError("tile_sel needs a bank prepared with block_s")
        op = L.nw_prepared_sel if qscale is None else L.nw_prepared_sel_quant
        return op(q, p.s, p.s2, p.labels, p.sscale, scale, qscale, tile_sel, p.block_s, mode,
                  n_classes)
    if partials:
        op = {torch.int8: L.nw_prepared_partials_int8,
              torch.uint8: L.nw_prepared_partials_int4}.get(p.s.dtype, L.nw_prepared_partials)
    else:
        op = {torch.int8: L.nw_prepared_int8,
              torch.uint8: L.nw_prepared_int4}.get(p.s.dtype, L.nw_prepared)
    return op(q, p.s, p.s2, p.labels, p.sscale, scale, qscale, mode, n_classes)


@torch.no_grad()
def nw_prepared_plain(
    qfeat: torch.Tensor,
    prepared: PreparedSupport,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    tile_sel: Optional[torch.Tensor] = None,
    row_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``nw_fused_from_prepared``'s log-probs from the kernels' plain
    version on any device (``_nw_prepared_plain``; with ``tile_sel``
    ``_nw_prepared_sel_plain``): the reference K2, K4, K5 and K6 are held
    to. ``row_chunk`` bounds the rows of one plain pass, whose score matrix
    is ``(B, rows)``: the bank goes through in chunks of rows whose partials
    merge exactly (``parallel.merge_partials``)."""
    from nwhead_tpu_torch.parallel.sharded_bank import merge_partials

    q, scale, mode, qscale = _prepared_query(qfeat, prepared, kernel, kernel_params)
    if tile_sel is not None:
        return _nw_prepared_sel_plain(q, prepared, scale, mode, n_classes, qscale, tile_sel)
    S = prepared.labels.shape[0]
    if not row_chunk or row_chunk >= S:
        return _nw_prepared_plain(q, prepared, scale, mode, n_classes, qscale)
    parts = []
    for i in range(0, S, row_chunk):
        rows = PreparedSupport(*(None if f is None else f[i:i + row_chunk]
                                 for f in prepared[:4]))
        parts.append(_nw_prepared_plain(q, rows, scale, mode, n_classes, qscale, partials=True))
    return merge_partials(parts)


def query_tile(queries: int, n_classes: int, device=None) -> int:
    """The prepared head's query tile (``_tc_query_tile``) for a batch of
    ``queries`` over ``n_classes`` on ``device``: the batch streams the
    bank once per tile. A card's shared memory sets it; off a card, an
    H100's."""
    device = torch.device("cpu" if device is None else device)
    optin = (_smem_optin(_cuda.load_library(), device) if device.type == "cuda"
             else H100_SMEM_OPTIN)
    return _tc_query_tile(queries, n_classes, False, optin)


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
