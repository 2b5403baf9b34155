"""Raw-feature head lab: K1 (finalizing and ``partials``) and K3's dq and
ds passes on raw support rows, and K2 on an unsorted bank, timed in turns
on the card and split by device function, for this checkout or another.

The port's own lab (no JAX script has it), the sibling of
``prepared_head_lab``. Each case draws its query and support rows N(0, 1)
(numpy seed 0 + the case's index), labels uniform over the classes in bank
order (a streamed chunk's or a raw shard's: unsorted), and 3% of the rows
masked with NaN in their features, as ``chip_smoke.py``'s raw cases do. In
l2 mode (``euclidean``), f32 and bf16, it checks, then times by
``labs.timing.interleaved_time`` (in turns, the L2 flushed by a read):

* K1 ``nw_fwd_cuda`` (finalizing), K1 ``nw_fwd_partials_cuda`` and K3's dq
  pass ``nw_bwd_dq_cuda`` at the training episode (B = 8, S = 1,200,
  D = 512, C = 200), at B = 64 over the CUB bank's S = 5,994, and at a
  streamed chunk (B = 64, 65,536 rows, D = 512, C = 1,000); K3's ds pass
  ``nw_bwd_ds_cuda`` at the episode and at B = 64 (the training paths';
  with ``--ds_plans``, on this checkout's kernel, also at each query tile
  and cluster size its plan chooses among, ``fused_nw._ds_launch``);
* K2 ``nw_prepared_cuda`` on that chunk's rows prepared with
  ``keep_order=True`` (labels left unsorted, as a raw chunk's) and sorted
  by class (``prepare_support``'s default at C > 128): the label sum's
  cost on unsorted tiles beside sorted ones.

Each case is held first to its plain version (log-probs and partials f32
rtol = atol = 2e-4, bf16 atol 2e-3; dq and ds within 1e-3 (f32) or 2e-2
(bf16) of max|plain|). On the card each case's device functions are timed by
``torch.profiler`` (``attn_block_lab.device_split``, the L2 zeroed before
each call): pass 1 and the merge of K1, K2 and dq, ds's one kernel. ``--tree DIR`` imports
``nwhead_tpu_torch`` from DIR instead (another commit's checkout, e.g. a
``git archive`` of it; only entry points that every tree has are called);
run the lab by its path then, once per tree and in turns (A, B, B, A)::

    python -m nwhead_tpu_torch.labs.raw_head_lab
    python nwhead_tpu_torch/labs/raw_head_lab.py --tree DIR
    python -m nwhead_tpu_torch.labs.raw_head_lab --device cpu --tiny
    python -m nwhead_tpu_torch.labs.raw_head_lab --ds_plans

``--device cpu --tiny`` runs the public entry points (``nw_fused_log_probs``
and its gradient, ``nw_fused_partials``, ``nw_fused_from_prepared``, which
take the plain versions on the CPU) against the plain functions at small
shapes and times nothing. The last line is one JSON object: the tree, the
card, each case's ms, max |err| and device split.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

SHAPES = (  # name, B, S, D, C
    ("episode", 8, 1200, 512, 200),
    ("B=64 S=5,994", 64, 5994, 512, 200),
    ("stream chunk", 64, 65_536, 512, 1000),
)
TINY_SHAPES = (
    ("episode", 8, 120, 40, 20),
    ("B=64 S=5,994", 64, 300, 40, 20),
    ("stream chunk", 64, 1024, 40, 150),
)
MASKED = 0.03  # share of the rows masked, NaN in their features
CYCLES = 9  # rounds of interleaved_time
PRECISIONS = ("f32", "bf16")
TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}
GRAD_REL = {"f32": 1e-3, "bf16": 2e-2}


def _package(tree: Optional[str]):
    """``ops.fused_nw``, ``labs.timing`` and ``labs.attn_block_lab`` of this
    checkout, or of the one at ``tree``."""
    loaded = sys.modules.get("nwhead_tpu_torch")
    if tree is not None:
        tree = os.path.abspath(tree)
        if loaded is not None and not os.path.abspath(loaded.__file__).startswith(tree + os.sep):
            raise SystemExit("--tree: run the lab by its path, not with -m")
        sys.path.insert(0, tree)
    elif loaded is None:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    from nwhead_tpu_torch.labs import attn_block_lab, timing
    from nwhead_tpu_torch.ops import fused_nw

    return fused_nw, timing, attn_block_lab


def draw(seed: int, B: int, S: int, D: int, C: int, device):
    """``(q (B, D), s (S, D) f32 with NaN in masked rows, labels (S,) int32
    with -1 on them, valid (S,) bool, g (B, C))``, from numpy ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(device)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(device)
    valid = rng.random(S) > MASKED
    valid[0] = True
    s[torch.from_numpy(~valid).to(device)] = float("nan")
    labels = torch.from_numpy(
        np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(device)
    g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(device)
    return q, s, labels, torch.from_numpy(valid), g


# ds's plans compared by --ds_plans: (query tile, cluster size) per shape.
DS_PLANS = {"episode": ((8, 1), (8, 2), (8, 4)),
            "B=64 S=5,994": ((16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4))}


def cases(F, device, tiny: bool, precisions=PRECISIONS, ds_plans: bool = False):
    """``[(name, kernel, plain, args, prec, kind)]``: ``kernel`` the counted
    wrapper on the card, the public entry point on the CPU; ``plain`` the
    plain function on the same inputs; ``kind`` how they are compared
    (``log_probs``, ``partials`` or ``grad``). With ``ds_plans`` (on the
    card), ds at each plan of ``DS_PLANS`` too."""
    import torch

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    cpu = device.type == "cpu"
    out = []
    for ci, (shape, B, S, D, C) in enumerate(TINY_SHAPES if tiny else SHAPES):
        q, s, labels, valid, g = draw(ci, B, S, D, C, device)
        for prec in precisions:
            dt = dtypes[prec]
            mode, scale, _, _ = F._resolve_mode("euclidean", {}, q)
            qn, sn = q.to(dt).contiguous(), s.to(dt).contiguous()
            fwd = (qn, sn, labels, scale, mode, C)
            o, m, l = F._nw_fwd_plain(*fwd)
            u = (g * torch.exp(-o)).contiguous()
            r = torch.sum(u * (torch.exp(o) - 1e-12), dim=-1, keepdim=True)
            bwd = (qn, sn, labels, u, r, m, l, scale, mode, C)
            sy = labels.clamp(min=0).cpu().numpy()
            mask = valid.float()

            def k1(*a, qn=qn, sn=sn, sy=sy, mask=mask, C=C):
                return F.nw_fused_log_probs(qn, sn, sy, C, support_mask=mask)

            def k1_partials(*a, qn=qn, sn=sn, sy=sy, mask=mask, C=C, prec=prec):
                return F.nw_fused_partials(qn, sn, sy, C, support_mask=mask,
                                           precision=prec)

            def dq(*a, qn=qn, sn=sn, sy=sy, mask=mask, C=C, g=g):
                qg = qn.detach().clone().requires_grad_(True)
                lp = F.nw_fused_log_probs(qg, sn, sy, C, support_mask=mask)
                return torch.autograd.grad(lp, qg, g.to(lp.dtype))[0]

            def ds(*a, qn=qn, sn=sn, sy=sy, mask=mask, C=C, g=g):
                sg = sn.detach().clone().requires_grad_(True)
                lp = F.nw_fused_log_probs(qn, sg, sy, C, support_mask=mask)
                return torch.autograd.grad(lp, sg, g.to(lp.dtype))[0]

            out += [
                (f"K1 {prec} {shape}", k1 if cpu else F.nw_fwd_cuda,
                 lambda *a: F._nw_fwd_plain(*a)[0], fwd, prec, "log_probs"),
                (f"K1 partials {prec} {shape}", k1_partials if cpu else F.nw_fwd_partials_cuda,
                 F._nw_fwd_partials_plain, fwd, prec, "partials"),
                (f"K3 dq {prec} {shape}", dq if cpu else F.nw_bwd_dq_cuda, F._nw_bwd_dq_plain,
                 bwd, prec, "grad"),
            ]
            if shape in DS_PLANS:
                out.append((f"K3 ds {prec} {shape}", ds if cpu else F.nw_bwd_ds_cuda,
                            F._nw_bwd_ds_plain, bwd, prec, "grad"))
            for qb, cl in DS_PLANS.get(shape, ()) if ds_plans and not cpu else ():
                out.append((f"K3 ds {prec} {shape} qb {qb} cluster {cl}",
                            lambda *a, qb=qb, cl=cl: F._ds_launch(*a, plan=(qb, cl, a[0].shape[0])),
                            F._nw_bwd_ds_plain, bwd, prec, "grad"))
            if shape == "stream chunk":
                for order, keep in (("unsorted", True), ("sorted", False)):
                    prep = F.prepare_support(s.to(dt), labels.clamp(min=0).cpu().numpy(), C,
                                             support_mask=valid.float(), precision=prec,
                                             keep_order=keep)
                    qq, sc, md, _ = F._prepared_query(q, prep)
                    args = (qq, prep, sc, md, C)
                    kernel = ((lambda *a, qq=q, prep=prep, C=C:
                               F.nw_fused_from_prepared(qq, prep, C)) if cpu
                              else F.nw_prepared_cuda)
                    out.append((f"K2 {prec} {order} bank, {shape}", kernel,
                                F._nw_prepared_plain, args, prec, "log_probs"))
    return out


def check(name: str, got, want, prec: str, kind: str) -> float:
    """The kernel's output against the plain version's; raises if it
    disagrees. Returns max |err| (dq: relative to max|plain|)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for gt, w in zip(got, want):
        gt, w = gt.float(), w.float()
        finite = bool(torch.isfinite(gt).all())
        if kind == "grad":
            e = float((gt - w).abs().max() / w.abs().max().clamp(min=1e-30))
            ok = finite and e <= GRAD_REL[prec]
        else:
            tol = TOL[prec] if kind == "log_probs" else dict(rtol=TOL[prec]["atol"],
                                                               atol=TOL[prec]["atol"])
            e = float((gt - w).abs().max())
            ok = finite and bool(((gt - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())
        if not ok:
            raise AssertionError(f"{name}: disagrees with its plain version (err {e:.3e})")
        err = max(err, e)
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="small shapes")
    ap.add_argument("--tree", default=None, help="import nwhead_tpu_torch from this checkout")
    ap.add_argument("--ds_plans", action="store_true",
                    help="also time ds at each query tile and cluster size (this checkout)")
    args = ap.parse_args(argv)
    F, timing, attn_lab = _package(args.tree)
    import torch

    device = timing.lab_device(args.device)
    card = timing.card_line(device)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(F.__file__))))
    print(f"card: {card}; package: {tree}")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    result: dict = {"tree": tree, "card": card, "ms": {}, "split": {}, "max_abs_err": {}}
    flush = torch.empty(timing.FLUSH_BYTES // 4, device=device) if device.type == "cuda" else None
    todo = cases(F, device, args.tiny, ds_plans=args.ds_plans)
    for name, kernel, plain, a, prec, kind in todo:
        err = check(name, kernel(*a), plain(*a), prec, kind)
        result["max_abs_err"][name] = err
        print(f"{name}: {'rel ' if kind == 'grad' else ''}max|err| {err:.3e}")
        if device.type == "cuda":
            split = {}
            for _ in range(3):  # the profiler sometimes records no device time
                split = split or attn_lab.device_split(lambda k=kernel, a=a: k(*a), flush)
            result["split"][name] = split
            print(attn_lab.split_line(name, split))
    if device.type == "cuda":
        t = timing.interleaved_time([(name, k, a) for name, k, _, a, _, _ in todo], CYCLES)
        for name, sec in t.items():
            result["ms"][name] = sec * 1e3
            print(f"time {name}: {sec * 1e3:.4f} ms")
    else:
        print("timing not measured (the plain versions on the CPU)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
