"""Kernel lab: the fused NW forward decomposed and its options compared, on
the card.

Port of ``scripts/kernel_lab.py``. At the CUB headline shape (B=64,
S=5,994, D=512, C=200, f32, numpy seed 0) it measures the read rate
(``stream_reduce``, the calibration), K1 (``nw_fused_log_probs``, the
library's current kernel), and ``fused_variant``, the raw l2 forward with
the lab's options, each checked against the naive op
(``nwhead_tpu_torch.ops.nw.nw_log_probs``) before it is timed::

    python -m nwhead_tpu_torch.labs.kernel_lab [--quick] [--interleave]
    python -m nwhead_tpu_torch.labs.kernel_lab --device cpu --tiny

The default mode times the stream at four tile settings, K1, the options one
at a time (``DECOMPOSITION``) and the block-size sweep (``SWEEP``; ``--quick``
its first four) in one interleaved loop; ``--interleave`` puts the options
beside the stream and adds the B=8 bandwidth-bound point. Each line prints
the time and ``frac_vs_stream``, the bank's f32 bytes over the measured
stream rate, divided by the time. A CPU run checks the plain versions and
times nothing.

``fused_variant`` runs ``csrc/lab_nw.cu`` on CUDA tensors: the forward's
tensor-core pass 1 that K1 and K2 run (``csrc/nw_pass1.cuh``; see
``lab_nw.cu`` for how each option maps onto it), and
``_fused_variant_plain`` on CPU tensors. Ported semantics, not the TPU's
layouts:

* ``labels`` ``wide``, ``wide_u8`` and ``compact`` were three label layouts
  of one function: all three take int32 labels, ``-1`` masked;
* ``dist`` ``f32`` (dot products and self-norms from the raw rows: K1's
  route), ``f32s2`` (the self-norms computed once outside the kernel),
  ``x3`` (q and s split into bf16 hi and lo, ``qh.sh + ql.sh + qh.sl`` on
  bf16 tensor cores, f32 sums); ``agg`` ``f32`` or ``split`` (p replaced
  by ``f32(bf16(p)) + f32(bf16(p - bf16(p)))`` before the label sum);
  ``cast="bf16"`` rounds q and s to bf16 first;
* ``block_s`` is the rows a split streams, rounded up to the pass's 64-row
  tiles; ``block_b`` picks the pass's query tile (32, 16 or 8 as C allows,
  ``variant_plan``); ``k1_block_s`` is the block_s of K1's own split count;
* ``mm_prec`` and ``agg_prec`` are accepted and change nothing: the
  kernel's f32 products are 3xTF32 (about JAX's ``highest``), x3's are
  exact bf16 products summed in f32.

The lab's timing probes (``labels="none"``: synthetic labels, no mask;
``dist="skip"``: no distance product; ``agg="skip"``: no label sum) compute
other functions and raise ``ValueError`` (``ROADMAP.md``, "do not carry
over").
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device
from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops import fused_nw as F
from nwhead_tpu_torch.ops.nw import LOG_FLOOR

_NEG_INF = float(torch.finfo(torch.float32).min)
LABELS = ("wide", "wide_u8", "compact")
DISTS = ("f32", "f32s2", "x3")
AGGS = ("f32", "split")
CASTS = ("f32", "bf16")
PRECISIONS = ("default", "high", "highest")
_PROBES = {"labels": "none", "dist": "skip", "agg": "skip"}
_DIST_CODE = {"f32": 0, "f32s2": 1, "x3": 2}

# The options one at a time at the lab's default tile (the variants the
# chip smoke holds to their plain versions), then the JAX lab's sweep.
DECOMPOSITION = (
    dict(labels="compact", dist="f32", agg="f32", block_s=2048),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=2048),
    dict(labels="compact", dist="x3", agg="f32", block_s=2048),
    dict(labels="compact", dist="f32s2", agg="split", block_s=2048),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=2048, cast="bf16"),
)
SWEEP = (
    dict(labels="compact", dist="f32s2", agg="f32", block_s=512),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=768),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=1024),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=1536),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=1024, cast="bf16"),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=2048, cast="bf16"),
)
# The stream settings timed as the calibration, (block_s, touch_only); the
# yardstick is K13's (2048, True).
STREAM_SETTINGS = ((2048, False), (1024, True), (2048, True), (4096, True))
BANDWIDTH_POINT = (  # B=8: compute far below the bank's bytes
    dict(labels="compact", dist="f32s2", agg="f32", block_s=2048),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=1024),
    dict(labels="compact", dist="f32s2", agg="f32", block_s=2048, cast="bf16"),
)


def variant_key(dist: str, agg: str, cast: str) -> str:
    """The name a variant's launches are counted under."""
    return f"{dist}/{agg}/{cast}"


def variant_name(v: dict) -> str:
    return (f"{v['labels']:7s} {v['dist']:5s} agg={v['agg']:5s} bs={v['block_s']:<5d} "
            f"{v.get('cast', 'f32')}")


def _check_options(labels, dist, agg, cast, mm_prec, agg_prec, block_s, block_b):
    for arg, value in (("labels", labels), ("dist", dist), ("agg", agg)):
        if value == _PROBES[arg]:
            raise ValueError(
                f"{arg}={value!r} is a timing probe of the TPU lab that computes another "
                "function; it is not ported (ROADMAP.md, 'do not carry over')")
    for arg, value, allowed in (("labels", labels, LABELS), ("dist", dist, DISTS),
                                ("agg", agg, AGGS), ("cast", cast, CASTS),
                                ("mm_prec", mm_prec, PRECISIONS),
                                ("agg_prec", agg_prec, PRECISIONS)):
        if value not in allowed:
            raise ValueError(f"{arg}={value!r}: expected one of {allowed}")
    if block_s < 1 or (block_b is not None and block_b < 1):
        raise ValueError(f"block_s={block_s} and block_b={block_b} must be positive")


class VariantInputs(NamedTuple):
    """A variant's operands as its kernel reads them."""

    q: torch.Tensor  # (B, D) f32 or bf16; x3: f32
    s: torch.Tensor  # (S, D) f32 or bf16; x3: the bf16 hi half
    s_lo: Optional[torch.Tensor]  # x3: the bf16 lo half, s - hi
    s2: Optional[torch.Tensor]  # f32s2 and x3: (S,) f32 self-norms
    cast: str  # "bf16" when q and s were rounded to bf16 first, else "f32"


def variant_inputs(q: torch.Tensor, s: torch.Tensor, dist: str) -> VariantInputs:
    """The operands of ``dist`` from ``q``, ``s`` of one dtype, computed
    once outside the kernel as the TPU lab computes them
    (``kernel_lab.py:328-341``)."""
    cast = "bf16" if s.dtype == torch.bfloat16 else "f32"
    if dist == "f32":
        return VariantInputs(q.contiguous(), s.contiguous(), None, None, cast)
    sf = s.to(torch.float32)
    s2 = torch.sum(sf * sf, dim=1)
    if dist == "f32s2":
        return VariantInputs(q.contiguous(), s.contiguous(), None, s2, cast)
    sh = sf.to(torch.bfloat16)
    sl = (sf - sh.to(torch.float32)).to(torch.bfloat16)
    return VariantInputs(q.to(torch.float32).contiguous(), sh.contiguous(), sl.contiguous(), s2,
                         cast)


def _bf16_split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _x3_dot(qf: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """x3's dot products in the kernel's order of the three sums
    (``csrc/nw_tc.cuh``: ``x3_product``): the small products ``ql.sh`` and
    ``qh.sl`` added first, then ``qh.sh``."""
    qh, ql = _bf16_split(qf)
    sh, sl = _bf16_split(sf)
    return qh @ sh.T + (ql @ sh.T + qh @ sl.T)


def _fused_variant_plain(q: torch.Tensor, s: torch.Tensor, labels: torch.Tensor,
                         n_classes: int, dist: str = "f32", agg: str = "f32") -> torch.Tensor:
    """``fused_variant``'s function in plain PyTorch, on ``q``, ``s`` after
    the cast and int32 ``labels`` (-1 masked): full f32 products (x3:
    ``_x3_dot``), the softmax taken at once. ``(B, C)`` f32 log-probs."""
    qf, sf = q.to(torch.float32), s.to(torch.float32)
    if dist == "x3":
        dot = _x3_dot(qf, sf)
    else:
        dot = qf @ sf.T
    valid = labels >= 0
    s2 = torch.sum(torch.where(valid[:, None], sf, 0.0) ** 2, dim=1)
    q2 = torch.sum(qf * qf, dim=1, keepdim=True)
    score = -torch.sqrt(torch.clamp(q2 - 2.0 * dot + s2[None, :], min=0.0))
    score = torch.where(valid[None, :], score, _NEG_INF)
    m = torch.max(score, dim=1, keepdim=True).values
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(score > _NEG_INF / 2, torch.exp(score - m_safe), 0.0)
    l = torch.sum(p, dim=1, keepdim=True)
    if agg == "split":
        ph, pl = _bf16_split(p)
        p = ph + pl
    cls = torch.where(valid, labels, n_classes).long()
    acc = torch.zeros(q.shape[0], n_classes + 1, dtype=torch.float32,
                      device=q.device).index_add_(1, cls, p)[:, :n_classes]
    return torch.log(acc / torch.clamp(l, min=1e-30) + LOG_FLOOR)


def variant_plan(B: int, S: int, n_classes: int, block_s: int, block_b: Optional[int] = None,
                 smem_optin: int = F.H100_SMEM_OPTIN):
    """The tensor-core pass 1's launch for the lab's tile options: ``(qb,
    rows, n_splits)``, the query tile (``block_b``, or the batch, rounded
    to 32, 16 or 8 as the classes' accumulator allows: ``_tc_query_tile``),
    the rows a split streams (``block_s`` rounded up to the pass's 64-row
    tiles) and the split count."""
    qb = F._tc_query_tile(block_b or B, n_classes, False, smem_optin)
    rows = F._round_up(block_s, F._TC_SUPPORT_TILE)
    return qb, rows, math.ceil(S / rows)


def k1_block_s(B: int, S: int, n_classes: int, n_sms: int,
               smem_optin: int = F.H100_SMEM_OPTIN) -> int:
    """The block_s that gives K1's own split count at this shape
    (``_tc_splits``: one wave of (query tile x split) blocks on ``n_sms``
    SMs): 128 at the CUB shape on an H100's 132 SMs, 47 splits."""
    qb = F._tc_query_tile(B, n_classes, False, smem_optin)
    return F._tc_splits(S, math.ceil(B / qb), n_sms)[0]


_ONES = {}  # device -> the (1,) f32 scale the pass reads (unused in l2 mode)


def fused_variant_cuda(x: VariantInputs, labels: torch.Tensor, n_classes: int, dist: str,
                       agg: str, block_s: int, block_b: Optional[int] = None) -> torch.Tensor:
    """Launch L1 ``fused_variant`` (``csrc/lab_nw.cu``) on operands from
    ``variant_inputs``: the tensor-core pass 1 over (query tiles x
    ``block_s`` splits, ``variant_plan``), then the exact merge and the
    log. Counts launches in ``.launches`` and per variant in
    ``.by_variant`` (``variant_key``)."""
    q, s = x.q, x.s
    if q.device.type != "cuda":
        raise ValueError(f"fused_variant_cuda needs CUDA tensors, got {q.device}")
    if dist not in DISTS or agg not in AGGS:
        raise ValueError(f"dist={dist!r}, agg={agg!r}")
    x3 = dist == "x3"
    want_q = torch.float32 if x3 else s.dtype
    if s.dtype not in (torch.float32, torch.bfloat16) or q.dtype != want_q or (
            x3 and s.dtype != torch.bfloat16):
        raise ValueError(f"fused_variant_cuda: query {q.dtype} / bank {s.dtype} for dist={dist}")
    if q.dim() != 2 or s.dim() != 2 or q.shape[1] != s.shape[1] or 0 in (*q.shape, *s.shape):
        raise ValueError(f"query {tuple(q.shape)} / bank {tuple(s.shape)}")
    (B, D), S = q.shape, s.shape[0]
    tensors = [("labels", labels, torch.int32, (S,))]
    if dist != "f32":
        tensors.append(("s2", x.s2, torch.float32, (S,)))
    if x3:
        tensors.append(("s_lo", x.s_lo, torch.bfloat16, (S, D)))
    for arg, t, dt, shape in tensors + [("query", q, want_q, (B, D)), ("bank", s, s.dtype, (S, D))]:
        if t is None or t.device != q.device or t.dtype != dt or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"fused_variant_cuda: {arg} needs contiguous {dt} {shape} on "
                             f"{q.device}")
    lib = _cuda.load_library("lab_nw")
    if n_classes < 1 or n_classes > _cuda.load_library().nw_prepared_max_classes(
            q.device.index or 0):
        raise ValueError(f"n_classes={n_classes} is beyond the kernel's shared-memory accumulator")
    qb, rows, n_splits = variant_plan(B, S, n_classes, block_s, block_b,
                                      lib.lab_optin_smem(q.device.index or 0))
    if q.device not in _ONES:
        _ONES[q.device] = torch.ones(1, dtype=torch.float32, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part, l_part = torch.empty((n_splits, B), **f32), torch.empty((n_splits, B), **f32)
    acc_part = torch.empty((n_splits, B, n_classes), **f32)
    out = torch.empty((B, n_classes), **f32)
    with torch.cuda.device(q.device):
        rc = lib.lab_fused_variant(
            q.data_ptr(), s.data_ptr(), None if x.s_lo is None else x.s_lo.data_ptr(),
            None if x.s2 is None else x.s2.data_ptr(), labels.data_ptr(),
            _ONES[q.device].data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), B, S, D, n_classes, _DIST_CODE[dist], int(agg == "split"),
            int(s.dtype == torch.bfloat16 and not x3), n_splits, rows, qb,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_variant_cuda kernel launch failed: "
                           f"{lib.lab_nw_error_string(rc).decode()}")
    fused_variant_cuda.launches += 1
    key = variant_key(dist, agg, x.cast)
    fused_variant_cuda.by_variant[key] = fused_variant_cuda.by_variant.get(key, 0) + 1
    return out


fused_variant_cuda.launches = 0
fused_variant_cuda.by_variant = {}


def fused_variant(q: torch.Tensor, s: torch.Tensor, sy, n_classes: int, *,
                  labels: str = "wide", dist: str = "f32", agg: str = "f32",
                  block_s: int = 2048, block_b: Optional[int] = None, cast: str = "f32",
                  mm_prec: str = "default", agg_prec: str = "default") -> torch.Tensor:
    """The raw l2 NW forward with the lab's options (see the module
    docstring): ``log(acc / max(l, 1e-30) + 1e-12)`` ``(B, C)`` from raw
    ``q (B, D)``, ``s (S, D)`` and labels ``sy`` (``-1`` masked). The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_options(labels, dist, agg, cast, mm_prec, agg_prec, block_s, block_b)
    if cast == "bf16":
        q, s = q.to(torch.bfloat16), s.to(torch.bfloat16)
    elif q.dtype != s.dtype:
        raise ValueError(f"query {q.dtype} and bank {s.dtype} differ")
    lab = torch.as_tensor(sy, device=s.device).to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return _fused_variant_plain(q, s, lab, n_classes, dist, agg)
    return fused_variant_cuda(variant_inputs(q, s, dist), lab, n_classes, dist, agg, block_s,
                              block_b)


def _relerr(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.max(torch.abs(out - ref) / (torch.abs(ref) + 1e-6)))


def main(argv=None) -> int:
    from nwhead_tpu_torch.ops.fused_nw import nw_fused_log_probs
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the sweep's first four only")
    ap.add_argument("--interleave", action="store_true",
                    help="the options beside the stream, and the B=8 point")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small shape (B=8, S=700, D=64)")
    args = ap.parse_args(argv)
    dev = lab_device(args.device)

    B, S, D, C = (8, 700, 64, 12) if args.tiny else (64, 5994, 512, 200)
    stream_rows = 2048 if args.tiny else 12288
    print(f"card: {card_line(dev)}; B={B}, S={S}, D={D}, C={C}", flush=True)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = torch.from_numpy(rng.integers(0, C, size=S).astype(np.int32)).to(dev)
    s_big = torch.from_numpy(rng.standard_normal((stream_rows, D)).astype(np.float32)).to(dev)
    ref = nw_log_probs(q, bank, sy, C)

    if args.interleave:
        variants = [dict(v, B=B) for v in DECOMPOSITION] + [dict(v, B=8) for v in BANDWIDTH_POINT]
    else:
        variants = [dict(v, B=B) for v in DECOMPOSITION + (SWEEP[:4] if args.quick else SWEEP)]
    failed = []
    for v in variants:
        if v["B"] != B:
            continue
        opts = {k: x for k, x in v.items() if k != "B"}
        err = _relerr(fused_variant(q, bank, sy, C, **opts), ref)
        tol = 2e-3 if opts.get("cast") == "bf16" else 1e-4
        print(f"  relerr {variant_name(opts)}: {err:.2e} {'ok' if err < tol else 'FAIL'}",
              flush=True)
        if not err < tol:
            failed.append(variant_name(opts))
    if failed:
        print(f"kernel_lab: variants disagree with the naive op: {failed}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    settings = ((2048, True),) if args.interleave else STREAM_SETTINGS
    for bs, t in settings:  # the tile mapping depends on block_s: each is checked first
        if not lab_stream.plain_agreement(lab_stream.stream_reduce(s_big, bs, t), s_big, bs, t)[0]:
            print(f"kernel_lab: stream bs={bs} touch={t} disagrees with its plain version",
                  file=sys.stderr)
            return 1
    stream_cases = [(f"stream bs={bs} touch={t}",
                     lambda bs=bs, t=t: lab_stream.stream_reduce(s_big, bs, t))
                    for bs, t in settings]
    cases = [(name, fn, ()) for name, fn in stream_cases]
    if not args.interleave:
        cases.append(("library current f32 (K1)", lambda: nw_fused_log_probs(q, bank, sy, C), ()))
    for v in variants:
        opts = {k: x for k, x in v.items() if k != "B"}
        qq = q if v["B"] == B else q[:v["B"]].contiguous()
        name = f"B={v['B']} {variant_name(opts)}"
        cases.append((name, lambda qq=qq, opts=opts: fused_variant(qq, bank, sy, C, **opts), ()))
    res = interleaved_time(cases)
    bank_bytes = lab_stream.stream_bytes(s_big, 2048)
    for name, _ in stream_cases:
        t = res[name]
        print(f"{name}: {t * 1e6:8.2f} us  {bank_bytes / t / 1e9:7.1f} GB/s (L2 flushed)",
              flush=True)
    bw = bank_bytes / res["stream bs=2048 touch=True"]  # the yardstick, K13's setting
    floor = S * D * 4 / bw
    for name, _ in stream_cases:
        del res[name]
    for name, t in res.items():
        print(f"{name}: {t * 1e6:8.2f} us  frac_vs_stream={floor / t:5.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
