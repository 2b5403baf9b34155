"""Prepared-head lab: K2 against the stream floor, by tile size and
precision, on the card.

Port of ``scripts/prepared_lab.py``. Times ``nw_fused_from_prepared(q, prep,
C)``, the serving call (K2, or K4 for an int8 bank), beside ``stream`` (K13)
in one interleaved loop, at the CUB shape (B=64, S=5,994, D=512, C=200,
numpy seed 0)::

    python -m nwhead_tpu_torch.labs.prepared_lab
    python -m nwhead_tpu_torch.labs.prepared_lab --device cpu --tiny

for ``block_s`` 512, 1,024 and 2,048 (f32), bf16 and int8 at 1,024, and B=256
at f32 and int8. On the card ``block_s`` only pads the bank to whole tiles:
K2 and K4 pick their own splits (``ops/fused_nw.py:_tc_splits``), so
the f32 rows differ by their padding. Parity comes
first, against the raw fused path (K1, the same arithmetic): f32 within
1e-3, bf16 3e-2, int8 3e-1 of the TPU
lab's relative error. Each line prints the time and the paired per-cycle
ratio ``bank_bytes / stream_bytes * t_stream / t_head``
(``scripts/roofline_lab.py:107-119``), the bank read once.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device, paired_ratio

TOL = {"f32": 1e-3, "bf16": 3e-2, "int8": 3e-1}


def relerr(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.max(torch.abs(out - ref) / (torch.abs(ref) + 1e-6)))


def bank_bytes(prep) -> int:
    return prep.s.numel() * prep.s.element_size()


def report(res, samples, t_name, heads, sbytes) -> None:
    """Print the stream's rate and each head's time and paired ratio."""
    t_stream = res[t_name]
    print(f"stream: {t_stream * 1e6:7.2f} us  {sbytes / t_stream / 1e9:6.1f} GB/s (L2 flushed)",
          flush=True)
    for name, nbytes in heads:
        frac = paired_ratio(samples, t_name, name, nbytes / sbytes)
        print(f"{name}: {res[name] * 1e6:7.2f} us  frac_vs_stream={frac:5.3f}", flush=True)


def main(argv=None) -> int:
    from nwhead_tpu_torch.ops.fused_nw import (
        nw_fused_from_prepared, nw_fused_log_probs, prepare_support,
    )
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small shape (B=8, S=700, D=64)")
    args = ap.parse_args(argv)
    dev = lab_device(args.device)

    B, S, D, C = (8, 700, 64, 12) if args.tiny else (64, 5994, 512, 200)
    print(f"card: {card_line(dev)}; B={B}, S={S}, D={D}, C={C}", flush=True)
    blocks = (128, 256, 512) if args.tiny else (512, 1024, 2048)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    q256 = torch.from_numpy(rng.standard_normal((4 * B, D)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = rng.integers(0, C, size=S).astype(np.int32)

    ref = nw_fused_log_probs(q, bank, torch.as_tensor(sy, device=dev), C)
    print(f"  raw-fused vs naive relerr: "
          f"{relerr(ref, nw_log_probs(q, bank, torch.as_tensor(sy, device=dev), C)):.2e}",
          flush=True)
    preps = {f"f32 bs={bs}": prepare_support(bank, sy, C, block_s=bs) for bs in blocks}
    preps[f"bf16 bs={blocks[1]}"] = prepare_support(bank, sy, C, precision="bf16",
                                                    block_s=blocks[1])
    preps[f"int8 bs={blocks[1]}"] = prepare_support(bank, sy, C, precision="int8",
                                                    block_s=blocks[1])
    failed = []
    for name, p in preps.items():
        err = relerr(nw_fused_from_prepared(q, p, C), ref)
        ok = err < TOL[name.split()[0]]
        print(f"  {'OK ' if ok else 'FAIL'} relerr {name}: {err:.2e}", flush=True)
        if not ok:
            failed.append(name)
    if failed:
        print(f"prepared_lab: heads disagree with the raw fused path: {failed}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    (_, _, (s_big,)), sbytes = lab_stream.stream_case(rng, D, 2048 if args.tiny else 12288,
                                                      device=dev)
    t_name = f"stream {sbytes / 1e6:.1f}MB"
    cases = [(t_name, lab_stream.stream, (s_big,))]
    heads = []
    for name, p in preps.items():
        cases.append((f"head B={B} {name}", nw_fused_from_prepared, (q, p, C)))
        heads.append((cases[-1][0], bank_bytes(p)))
    for name in (f"f32 bs={blocks[1]}", f"int8 bs={blocks[1]}"):
        cases.append((f"head B={4 * B} {name}", nw_fused_from_prepared, (q256, preps[name], C)))
        heads.append((cases[-1][0], bank_bytes(preps[name])))
    res, samples = interleaved_time(cases, cycles=9, return_samples=True)
    report(res, samples, t_name, heads, sbytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
