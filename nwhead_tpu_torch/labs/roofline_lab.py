"""Roofline lab: the f32 prepared head (K2) against the stream floor, by
bank tile size, on the card.

Port of ``scripts/roofline_lab.py``. Times ``nw_fused_from_prepared`` (K2)
over f32 banks prepared with ``block_s`` 1,024, 2,048 and 3,072 beside
``stream`` (K13) in one interleaved loop, and prints each head's paired
per-cycle ratio ``bank_bytes / stream_bytes * t_stream / t_head``
(``scripts/roofline_lab.py:107-119``), after checking each against the raw
fused path (K1) within 1e-3::

    python -m nwhead_tpu_torch.labs.roofline_lab [--s 5994 --c 200 --d 512 --b 64]
    python -m nwhead_tpu_torch.labs.roofline_lab --device cpu --tiny

The TPU lab's ``skip`` leg (``int4_impl="_probe_skip"``, no dot product) was
a timing probe of another function and is not ported (``ROADMAP.md``, "do
not carry over").
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.prepared_lab import TOL, bank_bytes, relerr, report
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device


def main(argv=None) -> int:
    from nwhead_tpu_torch.ops.fused_nw import (
        nw_fused_from_prepared, nw_fused_log_probs, prepare_support,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--s", type=int, default=5994)
    ap.add_argument("--c", type=int, default=200)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--blocks", default="1024,2048,3072")
    ap.add_argument("--cycles", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a small shape (B=8, S=700, D=64, C=12, blocks 128,256,384)")
    args = ap.parse_args(argv)
    dev = lab_device(args.device)

    S, C, D, B = (700, 12, 64, 8) if args.tiny else (args.s, args.c, args.d, args.b)
    blocks = "128,256,384" if args.tiny else args.blocks
    print(f"card: {card_line(dev)}; B={B}, S={S}, D={D}, C={C}", flush=True)
    rng = np.random.default_rng(0)
    sfeat = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = rng.integers(0, C, S).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    ref = nw_fused_log_probs(q, sfeat, torch.as_tensor(sy, device=dev), C)

    preps, failed = {}, []
    for bs in (int(x) for x in blocks.split(",")):
        prep = prepare_support(sfeat, sy, C, block_s=bs)
        err = relerr(nw_fused_from_prepared(q, prep, C), ref)
        ok = err < TOL["f32"]
        print(f"  {'OK ' if ok else 'FAIL'} relerr full_bs{bs}: {err:.2e}", flush=True)
        if not ok:
            failed.append(bs)
        preps[bs] = prep
    if failed:
        print(f"roofline_lab: heads disagree with the raw fused path: {failed}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    (_, _, (s_big,)), sbytes = lab_stream.stream_case(rng, D, 2048 if args.tiny else 12288,
                                                      device=dev)
    cases = [("stream", lab_stream.stream, (s_big,))]
    heads = []
    for bs, prep in preps.items():
        cases.append((f"full_bs{bs}", nw_fused_from_prepared, (q, prep, C)))
        heads.append((f"full_bs{bs}", bank_bytes(prep)))
    res, samples = interleaved_time(cases, cycles=args.cycles, return_samples=True)
    report(res, samples, "stream", heads, sbytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
