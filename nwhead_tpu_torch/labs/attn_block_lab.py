"""Attention half-block lab: K10 and K10 int8 at ViT-S/14's and ViT-B/14's
widths, timed in turns on the card, for this checkout or another.

The port's own lab (no JAX script has it), the sibling of
``mlp_block_lab``. At B = 64 images of N = 257 tokens and (D, H) = (384, 6)
and (768, 12) it checks, then times by ``labs.timing.interleaved_time`` (in
turns, the L2 flushed by a read):

* K10 (``attention_block_bf16_cuda``) with no fold and with every fold
  (LayerNorm, LayerScale, residual);
* K10 int8 (``attention_block_int8_cuda``) with no fold and with every fold.

Each case is first held to its plain version within 1e-2 of max|plain| and
cosine >= 0.9999 (K10 int8 also prints its share of bit-equal elements).
The SHA-256 of K10 int8's output at each of the eight combinations of the
folds is printed, so that two checkouts' bits can be compared across two
processes; on the card, each case's device functions are timed by
``torch.profiler`` (``device_split``). ``--tree DIR`` imports
``nwhead_tpu_torch`` from DIR instead (another commit's checkout, e.g. a
``git archive`` of it); run the lab by its path then, once per tree and in
turns (A, B, B, A)::

    python -m nwhead_tpu_torch.labs.attn_block_lab
    python nwhead_tpu_torch/labs/attn_block_lab.py --tree DIR
    python -m nwhead_tpu_torch.labs.attn_block_lab --device cpu --tiny

The last line is one JSON object: the tree, the card, each case's ms, the
digests and the splits.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

B_IMAGES, N_TOKENS = 64, 257
WIDTHS = {"vit_s14": (384, 6), "vit_b14": (768, 12)}  # D, H
TINY = (2, 37, {"tiny": (64, 2)})  # B, N, {name: (D, H)}
CYCLES = 15  # rounds of interleaved_time
SPLIT_REPS = 10  # profiled calls a split averages
# Activation scales: x (or its LayerNorm) of unit variance, attention
# outputs within a few units.
A_IN, A_ATT = 5.0 / 127.0, 3.0 / 127.0


def _package(tree: Optional[str]):
    """``ops.fused_attn`` and ``labs.timing`` of this checkout, or of the
    one at ``tree``."""
    loaded = sys.modules.get("nwhead_tpu_torch")
    if tree is not None:
        tree = os.path.abspath(tree)
        if loaded is not None and not os.path.abspath(loaded.__file__).startswith(tree + os.sep):
            raise SystemExit("--tree: run the lab by its path, not with -m")
        sys.path.insert(0, tree)
    elif loaded is None:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    from nwhead_tpu_torch.labs import timing
    from nwhead_tpu_torch.ops import fused_attn

    return fused_attn, timing


def qdense(rng, din: int, dout: int):
    """Random int8 weights quantized per output channel, their scales and
    a bias (numpy)."""
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    scale = (np.abs(w).max(0) / np.float32(127.0)).astype(np.float32)
    return (np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale,
            (0.1 * rng.standard_normal(dout)).astype(np.float32))


def cases(FA, device, B: int, N: int, D: int, H: int, every_fold: bool = False):
    """``[(name, kernel, plain, args, int8)]`` at one width, inputs drawn
    with numpy from fixed seeds: no fold and every fold, or with
    ``every_fold`` each of the eight combinations of the folds."""
    import torch

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    w_qkv, b_qkv, w_proj, b_proj, ln_s, ln_b, gamma = (to(a.astype(np.float32)) for a in (
        rng.standard_normal((D, 3 * D)) / np.sqrt(D), 0.1 * rng.standard_normal(3 * D),
        rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D),
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    x = to(rng.standard_normal((B, N, D)).astype(np.float32)).to(bf)
    (wq, sq, bq), (wp, sp, bp) = ([to(a) for a in qdense(rng, D, o)] for o in (3 * D, D))
    scale = (D // H) ** -0.5
    folds = {"no folds": (None, None, 1e-6, None, False),
             "every fold": (ln_s, ln_b, 1e-6, gamma.to(bf), True)}
    if every_fold:
        folds = {f"ln={int(ln)} ls={int(ls)} residual={int(res)}":
                 (ln_s if ln else None, ln_b if ln else None, 1e-6, gamma.to(bf) if ls else None,
                  res) for ln, ls, res in itertools.product([False, True], repeat=3)}
    out = [(f"K10 {name}", FA.attention_block_bf16_cuda, FA._attention_block_bf16_plain,
            (x, w_qkv.to(bf), b_qkv, w_proj.to(bf), b_proj, H, scale) + f, False)
           for name, f in folds.items()]
    out += [(f"K10 int8 {name}", FA.attention_block_int8_cuda, FA._attention_block_int8_plain,
             (x, wq, sq, bq, A_IN, wp, sp, bp, A_ATT, H, scale) + f, True)
            for name, f in folds.items()]
    return out


def check(name: str, got, want, int8: bool) -> str:
    """The kernel's output against the plain version's; raises if it
    disagrees."""
    import torch

    got, want = got.float(), want.float()
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
    if not (bool(torch.isfinite(got).all()) and rel <= 1e-2 and cos >= 0.9999):
        raise AssertionError(f"{name}: rel {rel:.2e}, cosine {cos:.7f}")
    equal = f", bit-equal {float((got == want).double().mean()):.4f}" if int8 else ""
    return f"rel {rel:.2e}, cos {cos:.7f}{equal}"


def digest(t) -> str:
    """SHA-256 of a tensor's bytes, on the host."""
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _short(name: str) -> str:
    """A device function's name without its return type, namespace,
    template arguments and parameters."""
    name = name.removeprefix("void ").split("(")[0].split("<")[0]
    return name.rsplit("::", 1)[-1]


def device_split(fn, flush=None, reps: int = SPLIT_REPS) -> Dict[str, float]:
    """Mean device ms per call of each kernel launch that ``fn`` makes, in
    launch order, by ``torch.profiler`` (CUDA activity); a function launched
    twice in a call is named twice (``name#2``). ``flush`` (a CUDA tensor)
    is zeroed before each call, so the L2 starts cold; its kernel is left
    out. Empty when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
        return sorted(ev, key=lambda e: e.time_range.start)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as one:
        fn()
        torch.cuda.synchronize()
    own = {e.name for e in kernels(one)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in kernels(prof) if e.name in own]
    if not ev or len(ev) % reps:
        return {}
    per_call = len(ev) // reps
    out: Dict[str, float] = {}
    for i in range(per_call):
        name = _short(ev[i].name)
        label, n = name, 2
        while label in out:
            label, n = f"{name}#{n}", n + 1
        out[label] = float(np.mean([ev[i + r * per_call].time_range.elapsed_us()
                                    for r in range(reps)])) * 1e-3
    return out


def split_line(label: str, split: Dict[str, float]) -> str:
    """One printed line of a split: each device function's ms and their
    sum."""
    if not split:
        return f"split {label}: not measured (the profiler recorded no device time)"
    parts = ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
    return f"split {label}: {parts} (sum {sum(split.values()):.4f} ms)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small B, N and width")
    ap.add_argument("--tree", default=None, help="import nwhead_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    FA, timing = _package(args.tree)
    import torch

    device = timing.lab_device(args.device)
    card = timing.card_line(device)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(FA.__file__))))
    print(f"card: {card}; package: {tree}")
    B, N, widths = TINY if args.tiny else (B_IMAGES, N_TOKENS, WIDTHS)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    result: dict = {"tree": tree, "card": card, "ms": {}, "sha256": {}, "split": {}}
    flush = torch.empty(timing.FLUSH_BYTES // 4, device=device) if device.type == "cuda" else None
    for width, (D, H) in widths.items():
        for name, kernel, plain, a, int8 in cases(FA, device, B, N, D, H, every_fold=True):
            if int8:
                got = (plain if device.type == "cpu" else kernel)(*a)
                result["sha256"][f"{width} {name}"] = digest(got)
                print(f"sha256 {width} {name}: {digest(got)}")
        todo = cases(FA, device, B, N, D, H)
        for name, kernel, plain, a, int8 in todo:
            if device.type == "cpu":
                kernel = plain  # the plain version against itself: the CLI's path
            verdict = check(name, kernel(*a), plain(*a), int8)
            print(f"{width} (B={B}, N={N}, D={D}, H={H}) {name}: {verdict}")
            if device.type == "cuda":
                split = device_split(lambda k=kernel, a=a: k(*a), flush)
                result["split"][f"{width} {name}"] = split
                print(split_line(f"{width} {name}", split))
        if device.type != "cuda":
            continue
        t = timing.interleaved_time([(name, k, a) for name, k, _, a, _ in todo], CYCLES)
        for name, sec in t.items():
            result["ms"][f"{width} {name}"] = sec * 1e3
            print(f"time {width} {name}: {sec * 1e3:.4f} ms")
    if device.type != "cuda":
        print("timing not measured (the plain versions on the CPU)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
