"""MLP half-block lab: K9, K11 and K11 int8 at ViT-S/14's and ViT-B/14's
widths, timed in turns on the card, for this checkout or another.

The port's own lab (no JAX script has it). At M = 16,448 tokens (B = 64
images of 257) and (D, D_h) = (384, 1,536) and (768, 3,072) it checks, then
times by ``labs.timing.interleaved_time`` (in turns, the L2 flushed by a
read):

* K9 in bf16 (``mlp_cuda``);
* K11 (``mlp_block_bf16_cuda``) with no fold, with the LayerNorm alone,
  with the LayerScale and the residual alone, and with every fold;
* K11 int8 (``mlp_block_int8_cuda``) with no fold and with every fold.

Each case is first held to its plain version: bf16 within 1e-2 of
max|plain| and cosine >= 0.9999, int8 bit for bit. ``--tree DIR`` imports
``nwhead_tpu_torch`` from DIR instead (another commit's checkout, e.g. a
``git archive`` of it), so that two commits are timed on one card; run the
lab by its path then, once per tree and in turns (A, B, B, A)::

    python -m nwhead_tpu_torch.labs.mlp_block_lab
    python nwhead_tpu_torch/labs/mlp_block_lab.py --tree DIR
    python -m nwhead_tpu_torch.labs.mlp_block_lab --device cpu --tiny

The last line is one JSON object: the tree, the card and each case's ms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

M_TOKENS = 64 * 257
WIDTHS = {"vit_s14": (384, 1536), "vit_b14": (768, 3072)}
TINY = (37, {"tiny": (64, 100)})  # M, {name: (D, D_h)}
CYCLES = 15  # rounds of interleaved_time
# Activation scales of the order calibration gives unit-variance inputs.
A_IN, A_HIDDEN = 5.0 / 127.0, 4.0 / 127.0


def _package(tree: Optional[str]):
    """``ops.fused_mlp`` and ``labs.timing`` of this checkout, or of the
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
    from nwhead_tpu_torch.ops import fused_mlp

    return fused_mlp, timing


def qdense(rng, din: int, dout: int):
    """Random int8 weights quantized per output channel, their scales and
    a bias (numpy)."""
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    scale = (np.abs(w).max(0) / np.float32(127.0)).astype(np.float32)
    return (np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale,
            (0.1 * rng.standard_normal(dout)).astype(np.float32))


def cases(FM, device, M: int, D: int, Dh: int):
    """``[(name, kernel, plain, args, exact)]`` at one width, inputs drawn
    with numpy from fixed seeds."""
    import torch

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    w1, b1, w2, b2, ln_s, ln_b, gamma = (to(a.astype(np.float32)) for a in (
        rng.standard_normal((D, Dh)) / np.sqrt(D), 0.1 * rng.standard_normal(Dh),
        rng.standard_normal((Dh, D)) / np.sqrt(Dh), 0.1 * rng.standard_normal(D),
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    x = to(rng.standard_normal((M, D)).astype(np.float32)).to(bf)
    (q1, s1, c1), (q2, s2, c2) = ([to(a) for a in qdense(rng, i, o)] for i, o in ((D, Dh), (Dh, D)))
    mlp = (x, w1.to(bf), b1, w2.to(bf), b2)
    folds = {"no folds": (None, None, 1e-6, None, False),
             "LayerNorm": (ln_s, ln_b, 1e-6, None, False),
             "LayerScale, residual": (None, None, 1e-6, gamma.to(bf), True),
             "every fold": (ln_s, ln_b, 1e-6, gamma.to(bf), True)}
    out = [("K9 bf16", FM.mlp_cuda, FM._mlp_plain, mlp, False)]
    out += [(f"K11 {name}", FM.mlp_block_bf16_cuda, FM._mlp_block_bf16_plain, mlp + f, False)
            for name, f in folds.items()]
    int8 = (x, q1, s1, c1, A_IN, q2, s2, c2, A_HIDDEN)
    out += [(f"K11 int8 {name}", FM.mlp_block_int8_cuda, FM._mlp_block_int8_plain,
             int8 + folds[name], True) for name in ("no folds", "every fold")]
    return out


def check(name: str, got, want, exact: bool) -> str:
    """The kernel's output against the plain version's; raises if it
    disagrees."""
    import torch

    got, want = got.float(), want.float()
    if exact:
        equal = float((got == want).float().mean())
        if equal != 1.0:
            raise AssertionError(f"{name}: bit-equal {equal:.4f}, want 1.0000")
        return "bit-equal 1.0000"
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
    if not (bool(torch.isfinite(got).all()) and rel <= 1e-2 and cos >= 0.9999):
        raise AssertionError(f"{name}: rel {rel:.2e}, cosine {cos:.7f}")
    return f"rel {rel:.2e}, cos {cos:.7f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small M and width")
    ap.add_argument("--tree", default=None, help="import nwhead_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    FM, timing = _package(args.tree)
    import torch

    device = timing.lab_device(args.device)
    card = timing.card_line(device)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(FM.__file__))))
    print(f"card: {card}; package: {tree}")
    M, widths = TINY if args.tiny else (M_TOKENS, WIDTHS)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    result = {}
    for width, (D, Dh) in widths.items():
        todo = cases(FM, device, M, D, Dh)
        for name, kernel, plain, a, exact in todo:
            if device.type == "cpu":
                kernel = plain  # the plain version against itself: the CLI's path
            verdict = check(name, kernel(*a), plain(*a), exact)
            print(f"{width} (M={M}, D={D}, D_h={Dh}) {name}: {verdict}")
        if device.type != "cuda":
            continue
        t = timing.interleaved_time([(name, k, a) for name, k, _, a, _ in todo], CYCLES)
        for name, sec in t.items():
            result[f"{width} {name}"] = sec * 1e3
            print(f"time {width} {name}: {sec * 1e3:.4f} ms")
    if device.type != "cuda":
        print("timing not measured (the plain versions on the CPU)")
    print(json.dumps({"tree": tree, "card": card, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
