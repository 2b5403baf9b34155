"""Prepared-bank head lab: K2, K4, K5 and K6 on f32, bf16, int8 and int4
banks, timed in turns on the card and split by device function, for this
checkout or another.

The port's own lab (no JAX script has it), the sibling of
``attn_block_lab``. At B = 64 queries it checks, then times by
``labs.timing.interleaved_time`` (in turns, the L2 flushed by a read):

* the full pass (K2 ``nw_prepared_cuda`` on f32/bf16 banks, K4
  ``nw_prepared_int8_cuda``, K5 ``nw_prepared_int4_cuda``) and its partials
  route (``nw_prepared_partials_cuda``, ``..._int8_cuda``,
  ``..._int4_cuda``) on the million-row bank: 1,048,576 rows, D = 512,
  C = 1,000, the last 48,576 masked, drawn as ``chip_smoke.py`` draws its
  ``IVF_BANK`` (class centres N(0, 1), rows a centre plus N(0, 0.5^2)
  noise, numpy seed 6);
* the partials route on one of four 250,000-row shards of that bank (the
  sharded full predict runs four);
* the full pass on the CUB bank (S = 5,994, D = 512, C = 200, Gaussian
  rows, 3% masked) and on the ViT-S/14 serving bank's shape (S = 5,800,
  D = 384);
* K6 (``nw_prepared_sel_cuda``, ``nw_prepared_sel_quant_cuda``) on the
  million-row bank built by ``prepare_support_ivf`` at 1,024-row tiles (not
  masked), for the skewed batch (64 queries of 4 classes, n_probe 8, one
  union) and the diverse one (64 classes, n_probe 4, group_b 16), as
  ``chip_smoke.py``'s K6 phase, and at full probe (every tile).

Each at every bank precision (``--precisions`` picks some), held first to
its plain version (f32, int8 and int4 rtol = atol = 2e-4, bf16 atol 2e-3),
and printed with its split count and the bytes of its per-split partials
(``(m, l, acc)`` of every split, written by pass 1 and read by pass 2). On
the card each case's device functions are timed by ``torch.profiler``
(``attn_block_lab.device_split``, the L2 zeroed before each call): pass 1
and the merge. ``--tree DIR`` imports ``nwhead_tpu_torch`` from DIR instead
(another commit's checkout, e.g. a ``git archive`` of it); run the lab by
its path then, once per tree and in turns (A, B, B, A)::

    python -m nwhead_tpu_torch.labs.prepared_head_lab
    python nwhead_tpu_torch/labs/prepared_head_lab.py --tree DIR --precisions int8,int4
    python -m nwhead_tpu_torch.labs.prepared_head_lab --device cpu --tiny

``--device cpu --tiny`` runs the public entry point
(``nw_fused_from_prepared``, which takes the plain versions on the CPU)
against the plain functions at a small bank and times nothing. The last
line is one JSON object: the tree, the card, each case's ms, split count,
partials bytes and device split.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

B_QUERIES = 64
BANK = (1 << 20, 512, 1000, 1024)  # rows, D, classes, rows per IVF tile
LIVE = 1_000_000  # rows of the million-row bank K2 serves; the rest masked
SHARD = 250_000  # rows of one of four shards of the million-row bank
CUB = (5994, 512, 200)  # S, D, C
VIT = (5800, 384, 200)  # the ViT-S/14 serving bank
TINY_BANK = (4096, 32, 300, 256)
TINY_LIVE = 4000
TINY_SHARD = 1000
TINY_CUB = (700, 40, 150)
TINY_VIT = (600, 24, 150)
SEED = 6  # chip_smoke.py's IVF_SEED
NOISE = 0.5
BATCHES = (("skewed", 4, 8, None), ("diverse", 64, 4, 16))  # classes, n_probe, group_b
CYCLES = 9  # rounds of interleaved_time
PRECISIONS = ("f32", "bf16", "int8", "int4")
# The integer products are exact on both sides, so int8/int4 hold f32's bound.
TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3),
       "int8": dict(rtol=2e-4, atol=2e-4), "int4": dict(rtol=2e-4, atol=2e-4)}
# Bank precision -> the full pass's name and wrappers: finalizing, partials,
# tile-selected.
KERNELS = {
    "f32": ("K2", "nw_prepared_cuda", "nw_prepared_partials_cuda", "nw_prepared_sel_cuda"),
    "bf16": ("K2", "nw_prepared_cuda", "nw_prepared_partials_cuda", "nw_prepared_sel_cuda"),
    "int8": ("K4", "nw_prepared_int8_cuda", "nw_prepared_partials_int8_cuda",
             "nw_prepared_sel_quant_cuda"),
    "int4": ("K5", "nw_prepared_int4_cuda", "nw_prepared_partials_int4_cuda",
             "nw_prepared_sel_quant_cuda"),
}


def _package(tree: Optional[str]):
    """``ops.fused_nw``, ``ops.ivf``, ``labs.timing`` and
    ``labs.attn_block_lab`` of this checkout, or of the one at ``tree``."""
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
    from nwhead_tpu_torch.ops import fused_nw, ivf

    return fused_nw, ivf, timing, attn_block_lab


def million_bank(device, bank=BANK):
    """``(features (S, D) f32, labels (S,), centres)``: class centres N(0,
    1) per feature, rows their class centre plus N(0, 0.5^2) noise, uniform
    labels, drawn with numpy from ``SEED`` in chunks of 131,072 rows."""
    import torch

    S, D, C, _ = bank
    rng = np.random.default_rng(SEED)
    cents = rng.standard_normal((C, D), dtype=np.float32)
    sy = rng.integers(0, C, S)
    s = torch.empty((S, D), dtype=torch.float32, device=device)
    for lo in range(0, S, 1 << 17):
        hi = min(S, lo + (1 << 17))
        noise = rng.standard_normal((hi - lo, D), dtype=np.float32)
        s[lo:hi] = torch.from_numpy(cents[sy[lo:hi]] + np.float32(NOISE) * noise).to(device)
    return s, sy, cents


def batches(cents, device) -> dict:
    """The skewed and the diverse batch (numpy seed ``SEED + 1``): each
    query its class centre plus N(0, 0.5^2) noise."""
    import torch

    C, D = cents.shape
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for name, n_cls, _, _ in BATCHES:
        qy = rng.choice(C, n_cls, replace=False)[rng.integers(0, n_cls, B_QUERIES)] \
            if n_cls < B_QUERIES else rng.choice(C, B_QUERIES, replace=False)
        noise = np.float32(NOISE) * rng.standard_normal((B_QUERIES, D), dtype=np.float32)
        out[name] = torch.from_numpy(cents[qy] + noise).to(device)
    return out


class SplitSpy:
    """Records the split count of each launch: every prepared-bank wrapper
    allocates its per-split partials through ``fused_nw._partials(n_splits,
    B, n_classes, ...)``."""

    def __init__(self, F):
        self.F, self.real, self.calls = F, F._partials, []
        F._partials = self

    def __call__(self, n_splits, B, n_classes, *args, **kwargs):
        self.calls.append((n_splits, B, n_classes))
        return self.real(n_splits, B, n_classes, *args, **kwargs)

    def last(self):
        """``(n_splits, partials bytes)`` of the last launch: m and l (B,)
        and acc (B, C) per split, f32."""
        n, B, C = self.calls[-1]
        return n, 4 * n * B * (C + 2)

    def close(self):
        self.F._partials = self.real


def cases(F, I, device, tiny: bool, precisions=PRECISIONS):
    """``[(name, kernel, plain, args, prec)]``: ``kernel`` the counted
    wrapper on the card, the public entry point on the CPU; ``plain`` the
    plain function on the same inputs; ``prec`` the bank's precision."""
    import torch

    S, D, C, block_s = TINY_BANK if tiny else BANK
    live = TINY_LIVE if tiny else LIVE
    s, sy, cents = million_bank(device, (S, D, C, block_s))
    queries = batches(cents, device)
    q = queries["skewed"]
    mask = torch.zeros(S)
    mask[:live] = 1.0
    cpu = device.type == "cpu"

    def entry(qf, **kw):
        """The public entry point, for the CPU; ``a`` a wrapper's arguments."""
        return lambda *a: F.nw_fused_from_prepared(qf, a[1], a[4], **kw)

    def prepared(prec, feats, labels, n_classes, qf, **kw):
        """A wrapper's arguments: the query as the bank takes it, the bank."""
        prep = F.prepare_support(feats, labels, n_classes, precision=prec, **kw)
        qq, scale, mode, qscale = F._prepared_query(qf, prep)
        return (qq, prep, scale, mode, n_classes, qscale)

    out = []
    for prec in precisions:
        kname, full, part, _ = KERNELS[prec]
        args = prepared(prec, s, sy, C, q, support_mask=mask)
        for partials in (False, True):
            kernel = entry(q, partials=partials) if cpu else getattr(F, part if partials else full)
            out.append((f"{kname} {'partials ' if partials else ''}{prec} million-row bank",
                        kernel, lambda *a, p=partials: F._nw_prepared_plain(*a, partials=p),
                        args, prec))
    shard = TINY_SHARD if tiny else SHARD
    for prec in precisions:
        kname, _, part, _ = KERNELS[prec]
        out.append((f"{kname} partials {prec} 250,000-row shard",
                    entry(q, partials=True) if cpu else getattr(F, part),
                    lambda *a: F._nw_prepared_plain(*a, partials=True),
                    prepared(prec, s[:shard], sy[:shard], C, q), prec))
    for bank, (cs, cd, cc) in (("CUB bank", TINY_CUB if tiny else CUB),
                               ("ViT bank", TINY_VIT if tiny else VIT)):
        rng = np.random.default_rng(0)
        qc = torch.from_numpy(rng.standard_normal((B_QUERIES, cd), np.float32)).to(device)
        sc = torch.from_numpy(rng.standard_normal((cs, cd), np.float32)).to(device)
        syc = rng.integers(0, cc, size=cs)
        maskc = torch.from_numpy((rng.random(cs) > 0.03).astype(np.float32))
        for prec in precisions:
            kname, full, _, _ = KERNELS[prec]
            out.append((f"{kname} {prec} {bank}", entry(qc) if cpu else getattr(F, full),
                        F._nw_prepared_plain,
                        prepared(prec, sc, syc, cc, qc, support_mask=maskc), prec))
    for prec in precisions:
        sel = KERNELS[prec][3]
        ivf = I.prepare_support_ivf(s, sy, C, precision=prec, block_s=block_s)
        full_probe = ("full probe", None, ivf.cents.shape[0], None)
        for name, _, n_probe, group_b in BATCHES + (full_probe,):
            qk, tsel, _ = I._ivf_route(queries.get(name, q), ivf, kernel="euclidean",
                                       kernel_params=None, n_probe=n_probe, group_b=group_b)
            qq, scale, mode, qscale = F._prepared_query(qk, ivf.prep)
            out.append((f"K6 {prec} {name}", entry(qk, tile_sel=tsel) if cpu else getattr(F, sel),
                        F._nw_prepared_sel_plain, (qq, ivf.prep, scale, mode, C, qscale, tsel),
                        prec))
    return out


def check(name: str, got, want, prec: str) -> float:
    """The kernel's output (log-probs, or ``(m, l, acc)``) against the
    plain version's; raises if it disagrees. Returns max |err|."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = TOL[prec] if len(got) == 1 else dict(rtol=TOL[prec]["atol"], atol=TOL[prec]["atol"])
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not (bool(torch.isfinite(g).all()) and
                bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())):
            raise AssertionError(f"{name}: disagrees with its plain version "
                                 f"(max|err| {float((g - w).abs().max()):.3e})")
        err = max(err, float((g - w).abs().max()))
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small bank")
    ap.add_argument("--tree", default=None, help="import nwhead_tpu_torch from this checkout")
    ap.add_argument("--precisions", default=",".join(PRECISIONS),
                    help="bank precisions, comma-separated (default: all four)")
    args = ap.parse_args(argv)
    precisions = tuple(args.precisions.split(","))
    if set(precisions) - set(PRECISIONS):
        ap.error(f"--precisions takes {', '.join(PRECISIONS)}")
    F, I, timing, attn_lab = _package(args.tree)
    import torch

    device = timing.lab_device(args.device)
    card = timing.card_line(device)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(F.__file__))))
    print(f"card: {card}; package: {tree}")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    result: dict = {"tree": tree, "card": card, "ms": {}, "splits": {}, "partials_bytes": {},
                    "split": {}, "max_abs_err": {}}
    flush = torch.empty(timing.FLUSH_BYTES // 4, device=device) if device.type == "cuda" else None
    spy = SplitSpy(F)
    try:
        todo = cases(F, I, device, args.tiny, precisions)
        for name, kernel, plain, a, prec in todo:
            got = kernel(*a)
            err = check(name, got, plain(*a), prec)
            result["max_abs_err"][name] = err
            line = f"{name}: max|err| {err:.3e}"
            if device.type == "cuda":
                n_splits, n_bytes = spy.last()
                result["splits"][name], result["partials_bytes"][name] = n_splits, n_bytes
                split = {}
                for _ in range(3):  # the profiler sometimes records no device time
                    split = split or attn_lab.device_split(lambda k=kernel, a=a: k(*a), flush)
                result["split"][name] = split
                line += f"; {n_splits} splits, partials {n_bytes / 1e6:.2f} MB"
                print(line)
                print(attn_lab.split_line(name, split))
            else:
                print(line)
        if device.type == "cuda":
            t = timing.interleaved_time([(name, k, a) for name, k, _, a, _ in todo], CYCLES)
            for name, sec in t.items():
                result["ms"][name] = sec * 1e3
                print(f"time {name}: {sec * 1e3:.4f} ms")
        else:
            print("timing not measured (the plain versions on the CPU)")
    finally:
        spy.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
