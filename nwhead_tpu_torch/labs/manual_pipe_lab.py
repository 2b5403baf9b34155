"""Manual pipeline lab: the NW forward over a prepared bank, one
``block_s`` tile a split, with the depth of each block's ring of bank
slices as its variable, beside K2 on the card.

Port of ``scripts/manual_pipe_lab.py``. The TPU lab asked whether a kernel
that prefetches its own bank tiles reaches the stream rate. Here
``manual_fused`` (``csrc/lab_nw.cu``) runs K2's prepared-bank route of the
forward's tensor-core pass 1 (``nw_prepared_tc_kernel``): TMA rings of
64-row x 128-byte slices fed by a producer warp, two scoring groups on the
tensor cores, on a grid of (query tiles) x (one ``block_s`` tile a split).
That grid has few blocks (12 at B=64 and ``block_s`` 1,024, 6 at B=8), so
each streams a whole split through its rings alone, and the lab reads the
rate one block reaches against the bytes its rings keep in flight
(``--stages``: 2, the TPU lab's double buffer; 3, K2's depth; 4, 6 and 7,
the deepest that fits at the CUB shape)::

    python -m nwhead_tpu_torch.labs.manual_pipe_lab
    python -m nwhead_tpu_torch.labs.manual_pipe_lab --stages 2,3,7
    python -m nwhead_tpu_torch.labs.manual_pipe_lab --device cpu --tiny

At the CUB shape (B=64, S=5,994, D=512, C=200, numpy seed 0) it checks
``manual_fused`` against the naive op at ``block_s`` 1,024 and 2,048 (f32
and bf16 banks) and at each stage count, then times in one interleaved
loop, at B=64 and B=8 and both precisions: ``manual_fused`` at ``block_s``
1,024 at every stage count, at 2,048 and at K2's own split count
(``_tc_splits``) at 3 stages, and K2 (``nw_prepared_cuda``) on the same
bank, every query already in the bank's dtype, beside the stream. Each
case prints its time, ``frac_vs_stream`` (the bank's bytes over the
measured stream rate, divided by the time), its blocks, the read rate per
block (the bytes a block streams, the bank's bytes over the splits,
divided by the time) and the bytes a block keeps in flight (2 groups x
stages x 64 rows x 128 bytes).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device
from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops import fused_nw as F
from nwhead_tpu_torch.ops.fused_nw import PreparedSupport, _nw_prepared_plain

MANUAL_STAGES = (2, 3, 4, 6, 7)  # the depths csrc/lab_nw.cu builds (kManualStages)
DEFAULT_STAGES = F._TC_STAGES  # K2's depth


def _manual_fused_plain(q: torch.Tensor, prep: PreparedSupport, n_classes: int) -> torch.Tensor:
    """``manual_fused``'s function in plain PyTorch: K2's l2 forward
    (``_nw_prepared_plain``) on ``q`` in the bank's dtype."""
    scale = torch.ones(1, dtype=torch.float32, device=q.device)
    return _nw_prepared_plain(q, prep, scale, "l2", n_classes)


def ring_bytes(stages: int) -> int:
    """Bank bytes a block keeps in flight: two scoring groups' rings of
    ``stages`` slices of 64 rows x 128 bytes."""
    return 2 * stages * F._TC_SUPPORT_TILE * F._TC_ROW_BYTES


def manual_plan(B: int, S_pad: int, block_s: int, n_classes: int, stages: int,
                smem_optin: int = F.H100_SMEM_OPTIN):
    """The launch of ``manual_fused``: ``(qb, rows_per_split, n_splits,
    smem)``, the pass's own query tile (``_tc_query_tile``), ``block_s``
    rounded up to whole 64-row tiles, one split each over the prepared
    bank's ``S_pad`` rows, and the block's shared memory with rings of
    ``stages`` slices. Refuses a depth the library is not built for, or a
    block that does not fit ``smem_optin``."""
    if stages not in MANUAL_STAGES:
        raise ValueError(f"stages={stages}: manual_fused is built for {MANUAL_STAGES}")
    qb = F._tc_query_tile(B, n_classes, False, smem_optin)
    smem = F._tc_smem_bytes(qb, n_classes, False, stages)
    if smem > smem_optin:
        raise ValueError(f"a ring of {stages} slices at a {qb}-query tile and "
                         f"n_classes={n_classes} needs {smem} bytes of shared memory, above the "
                         f"{smem_optin} a block may opt in to")
    rows = F._round_up(block_s, F._TC_SUPPORT_TILE)
    return qb, rows, math.ceil(S_pad / rows), smem


def _check_bank(prep: PreparedSupport) -> None:
    if prep.block_s is None:
        raise ValueError("manual_fused streams whole tiles: prepare the bank with block_s")
    if prep.s.dtype not in (torch.float32, torch.bfloat16) or prep.s2 is None:
        raise ValueError(f"manual_fused takes an l2 f32 or bf16 bank, got {prep.s.dtype}")


_ONES = {}  # device -> the (1,) f32 scale the pass reads (unused in l2 mode)


def manual_fused_cuda(q: torch.Tensor, prep: PreparedSupport, n_classes: int,
                      stages: int = DEFAULT_STAGES,
                      block_s: Optional[int] = None) -> torch.Tensor:
    """Launch L3 ``manual_fused`` (``csrc/lab_nw.cu``): ``q (B, D)`` in the
    bank's dtype; rings of ``stages`` slices; splits of ``block_s`` rows
    (default the bank's own ``block_s``: one tile a split), ``manual_plan``.
    Counts launches in ``.launches`` and per bank dtype in ``.by_variant``."""
    _check_bank(prep)
    s, s2, labels = prep.s, prep.s2, prep.labels
    if q.device.type != "cuda":
        raise ValueError(f"manual_fused_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 2 or q.shape[1] != s.shape[1] or q.shape[0] == 0 or q.dtype != s.dtype:
        raise ValueError(f"query {q.dtype} {tuple(q.shape)} for bank {s.dtype} {tuple(s.shape)}")
    (B, D), S = q.shape, s.shape[0]
    q = q.contiguous()
    for arg, t, dt in (("bank", s, s.dtype), ("s2", s2, torch.float32),
                       ("labels", labels, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"manual_fused_cuda: {arg} needs contiguous {dt} on {q.device}")
    lib = _cuda.load_library("lab_nw")
    device = q.device.index or 0
    if n_classes < 1 or n_classes > _cuda.load_library().nw_prepared_max_classes(device):
        raise ValueError(f"n_classes={n_classes} is beyond the kernel's shared-memory accumulator")
    qb, rows, n_splits, _ = manual_plan(B, S, block_s or prep.block_s, n_classes, stages,
                                        lib.lab_optin_smem(device))
    if q.device not in _ONES:
        _ONES[q.device] = torch.ones(1, dtype=torch.float32, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part, l_part = torch.empty((n_splits, B), **f32), torch.empty((n_splits, B), **f32)
    acc_part = torch.empty((n_splits, B, n_classes), **f32)
    out = torch.empty((B, n_classes), **f32)
    with torch.cuda.device(q.device):
        rc = lib.lab_manual_fused(q.data_ptr(), s.data_ptr(), s2.data_ptr(), labels.data_ptr(),
                                  _ONES[q.device].data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                                  acc_part.data_ptr(), out.data_ptr(), B, S, D, n_classes,
                                  int(s.dtype == torch.bfloat16), n_splits, rows, qb, stages,
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"manual_fused_cuda kernel launch failed: "
                           f"{lib.lab_nw_error_string(rc).decode()}")
    manual_fused_cuda.launches += 1
    key = "bf16" if s.dtype == torch.bfloat16 else "f32"
    manual_fused_cuda.by_variant[key] = manual_fused_cuda.by_variant.get(key, 0) + 1
    return out


manual_fused_cuda.launches = 0
manual_fused_cuda.by_variant = {}


def manual_fused(q: torch.Tensor, prepared: PreparedSupport, n_classes: int,
                 stages: int = DEFAULT_STAGES) -> torch.Tensor:
    """The l2 NW log-probs ``(B, C)`` of raw queries ``q`` over an
    euclidean ``prepare_support`` bank prepared with ``block_s`` (f32 or
    bf16), ``q`` cast to the bank's dtype; finalized as K2 finalizes. The
    kernel (rings of ``stages`` slices) on CUDA tensors, the plain version
    on CPU tensors, where the depth changes nothing."""
    _check_bank(prepared)
    if stages not in MANUAL_STAGES:
        raise ValueError(f"stages={stages}: manual_fused is built for {MANUAL_STAGES}")
    qc = q.to(prepared.s.dtype)
    if qc.device.type == "cpu":
        return _manual_fused_plain(qc, prepared, n_classes)
    return manual_fused_cuda(qc, prepared, n_classes, stages)


def main(argv=None) -> int:
    from nwhead_tpu_torch.ops.fused_nw import prepare_support
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small shape (B=8, S=700, D=64)")
    ap.add_argument("--stages", default=",".join(map(str, MANUAL_STAGES)),
                    help="ring depths of the sweep at the first block_s, comma-separated "
                         f"(of {', '.join(map(str, MANUAL_STAGES))})")
    args = ap.parse_args(argv)
    sweep = tuple(int(x) for x in args.stages.split(","))
    if set(sweep) - set(MANUAL_STAGES):
        ap.error(f"--stages takes {', '.join(map(str, MANUAL_STAGES))}")
    dev = lab_device(args.device)

    B, S, D, C = (8, 700, 64, 12) if args.tiny else (64, 5994, 512, 200)
    print(f"card: {card_line(dev)}; B={B}, S={S}, D={D}, C={C}", flush=True)
    blocks = (128, 256) if args.tiny else (1024, 2048)
    stream_rows = 2048 if args.tiny else 12288
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    ref = nw_log_probs(q, bank, torch.as_tensor(sy, device=dev), C)

    preps, failed = {}, []
    checks = [(bs, DEFAULT_STAGES) for bs in blocks] + [
        (blocks[0], st) for st in sweep if st != DEFAULT_STAGES]
    for prec in ("f32", "bf16"):
        for bs, st in checks:
            if (prec, bs) not in preps:
                preps[(prec, bs)] = prepare_support(bank, sy, C, precision=prec, block_s=bs)
            out = manual_fused(q, preps[(prec, bs)], C, st)
            err = float(torch.max(torch.abs(out - ref) / (torch.abs(ref) + 1e-6)))
            tol = 1e-4 if prec == "f32" else 2e-3
            ok = bool(torch.isfinite(out).all()) and err < tol
            print(f"manual {prec} bs={bs} stages={st} relerr: {err:.2e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(f"{prec} bs={bs} stages={st}")
    if failed:
        print(f"manual_pipe_lab: disagrees with the naive op: {failed}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    optin = _cuda.load_library("lab_nw").lab_optin_smem(dev.index or 0)
    s_big = torch.from_numpy(rng.standard_normal((stream_rows, D)).astype(np.float32)).to(dev)
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    cases, info = [("stream", lab_stream.stream, (s_big,))], {}
    for prec in ("f32", "bf16"):
        prep = preps[(prec, blocks[0])]
        for b in (B, 8):
            qc = q[:b].to(prep.s.dtype).contiguous()
            cases.append((f"K2 {prec} B={b}", F.nw_prepared_cuda, (qc, prep, ones, "l2", C)))
            S_pad = prep.s.shape[0]
            q_tiles = math.ceil(b / manual_plan(b, S_pad, blocks[0], C, DEFAULT_STAGES, optin)[0])
            k2_rows = F._tc_splits(S_pad, q_tiles, n_sms)[0]
            runs = [(f"bs={blocks[0]} stages={st}", prep, st, None) for st in sweep] + [
                (f"bs={blocks[1]} stages={DEFAULT_STAGES}", preps[(prec, blocks[1])],
                 DEFAULT_STAGES, None),
                (f"K2 splits (rows {k2_rows}) stages={DEFAULT_STAGES}", prep, DEFAULT_STAGES,
                 k2_rows)]
            for label, p, st, rows in runs:
                name = f"manual {prec} {label} B={b}"
                n_splits = manual_plan(b, p.s.shape[0], rows or p.block_s, C, st, optin)[2]
                info[name] = (q_tiles * n_splits, n_splits, st, p.s.numel() * p.s.element_size())
                cases.append((name, manual_fused_cuda, (qc, p, C, st, rows)))
    res = interleaved_time(cases)
    t_stream = res.pop("stream")
    bw = lab_stream.stream_bytes(s_big) / t_stream
    print(f"stream: {t_stream * 1e6:7.2f} us  {bw / 1e9:6.1f} GB/s (L2 flushed)", flush=True)
    for name, t in res.items():
        floor = S * D * (2 if " bf16 " in name else 4) / bw
        line = f"{name}: {t * 1e6:7.2f} us  frac_vs_stream={floor / t:5.3f}"
        if name in info:
            n_blocks, n_splits, st, bank_bytes = info[name]
            line += (f"  blocks={n_blocks}  per block "
                     f"{bank_bytes / n_splits / t / 1e9:6.2f} GB/s  in flight "
                     f"{ring_bytes(st)} B")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
