"""Manual pipeline lab: the NW forward over a prepared bank with
hand-prefetched bank tiles, beside K2, on the card.

Port of ``scripts/manual_pipe_lab.py``. The TPU lab asked whether a kernel
that double-buffers its own bank copies beats Mosaic's automatic pipeline.
Here the same question is asked of the card: K2 (``csrc/nw_prepared.cu``)
hides memory latency with occupancy, about 8 blocks a SM that do not
prefetch; ``manual_fused`` (``csrc/lab_nw.cu``) hides it by prefetching, a
two-stage ``cp.async`` ring of bank sub-tiles in each block, on a grid of
(query tiles of 16) x (one ``block_s`` tile a split)::

    python -m nwhead_tpu_torch.labs.manual_pipe_lab
    python -m nwhead_tpu_torch.labs.manual_pipe_lab --device cpu --tiny

At the CUB shape (B=64, S=5,994, D=512, C=200, numpy seed 0) it checks
``manual_fused`` against the naive op at ``block_s`` 1,024 and 2,048 (f32
and bf16 banks), then times it beside the stream and K2
(``nw_fused_from_prepared``) on the same banks at B=64 and B=8, in one
interleaved loop, printing ``frac_vs_stream``: the bank's bytes over the
measured stream rate, divided by the time.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device
from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops.fused_nw import PreparedSupport, _nw_prepared_plain


def _manual_fused_plain(q: torch.Tensor, prep: PreparedSupport, n_classes: int) -> torch.Tensor:
    """``manual_fused``'s function in plain PyTorch: K2's l2 forward
    (``_nw_prepared_plain``) on ``q`` in the bank's dtype."""
    scale = torch.ones(1, dtype=torch.float32, device=q.device)
    return _nw_prepared_plain(q, prep, scale, "l2", n_classes)


def _check_bank(prep: PreparedSupport) -> None:
    if prep.block_s is None:
        raise ValueError("manual_fused streams whole tiles: prepare the bank with block_s")
    if prep.s.dtype not in (torch.float32, torch.bfloat16) or prep.s2 is None:
        raise ValueError(f"manual_fused takes an l2 f32 or bf16 bank, got {prep.s.dtype}")


def manual_fused_cuda(q: torch.Tensor, prep: PreparedSupport, n_classes: int) -> torch.Tensor:
    """Launch L3 ``manual_fused`` (``csrc/lab_nw.cu``): ``q (B, D)`` in the
    bank's dtype. Counts launches in ``.launches`` and per bank dtype in
    ``.by_variant``."""
    _check_bank(prep)
    s, s2, labels = prep.s, prep.s2, prep.labels
    if q.device.type != "cuda":
        raise ValueError(f"manual_fused_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 2 or q.shape[1] != s.shape[1] or q.shape[0] == 0 or q.dtype != s.dtype:
        raise ValueError(f"query {q.dtype} {tuple(q.shape)} for bank {s.dtype} {tuple(s.shape)}")
    (B, D), S = q.shape, s.shape[0]
    if D % 8:
        raise ValueError(f"manual_fused copies 16-byte segments: D={D} must be a multiple of 8")
    q = q.contiguous()
    for arg, t, dt in (("bank", s, s.dtype), ("s2", s2, torch.float32),
                       ("labels", labels, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"manual_fused_cuda: {arg} needs contiguous {dt} on {q.device}")
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("manual_fused_cuda: query and bank must start on 16-byte boundaries")
    lib = _cuda.load_library("lab_nw")
    if lib.lab_manual_smem_bytes(n_classes, D, s.element_size()) > lib.lab_optin_smem(
            q.device.index or 0):
        raise ValueError(f"n_classes={n_classes}, D={D} are beyond the kernel's shared memory")
    n_splits = -(-S // prep.block_s)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part, l_part = torch.empty((n_splits, B), **f32), torch.empty((n_splits, B), **f32)
    acc_part = torch.empty((n_splits, B, n_classes), **f32)
    out = torch.empty((B, n_classes), **f32)
    with torch.cuda.device(q.device):
        rc = lib.lab_manual_fused(q.data_ptr(), s.data_ptr(), s2.data_ptr(), labels.data_ptr(),
                                  m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                                  out.data_ptr(), B, S, D, n_classes,
                                  int(s.dtype == torch.bfloat16), prep.block_s,
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


def manual_fused(q: torch.Tensor, prepared: PreparedSupport, n_classes: int) -> torch.Tensor:
    """The l2 NW log-probs ``(B, C)`` of raw queries ``q`` over an
    euclidean ``prepare_support`` bank prepared with ``block_s`` (f32 or
    bf16), ``q`` cast to the bank's dtype; finalized as K2 finalizes. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_bank(prepared)
    qc = q.to(prepared.s.dtype)
    if qc.device.type == "cpu":
        return _manual_fused_plain(qc, prepared, n_classes)
    return manual_fused_cuda(qc, prepared, n_classes)


def main(argv=None) -> int:
    from nwhead_tpu_torch.ops.fused_nw import nw_fused_from_prepared, prepare_support
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small shape (B=8, S=700, D=64)")
    args = ap.parse_args(argv)
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
    for prec in ("f32", "bf16"):
        for bs in blocks:
            prep = prepare_support(bank, sy, C, precision=prec, block_s=bs)
            out = manual_fused(q, prep, C)
            err = float(torch.max(torch.abs(out - ref) / (torch.abs(ref) + 1e-6)))
            tol = 1e-4 if prec == "f32" else 2e-3
            print(f"manual {prec} bs={bs} relerr: {err:.2e} {'ok' if err < tol else 'FAIL'}",
                  flush=True)
            if not err < tol:
                failed.append(f"{prec} bs={bs}")
            preps[(prec, bs)] = prep
    if failed:
        print(f"manual_pipe_lab: disagrees with the naive op: {failed}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    s_big = torch.from_numpy(rng.standard_normal((stream_rows, D)).astype(np.float32)).to(dev)
    cases = [("stream", lab_stream.stream, (s_big,))]
    for prec in ("f32", "bf16"):
        lib_prep = prepare_support(bank, sy, C, precision=prec)
        for b in (B, 8):
            qb = q[:b].contiguous()
            cases.append((f"K2 {prec} B={b}", nw_fused_from_prepared, (qb, lib_prep, C)))
            for bs in blocks:
                cases.append((f"manual {prec} bs={bs} B={b}", manual_fused,
                              (qb, preps[(prec, bs)], C)))
    res = interleaved_time(cases)
    t_stream = res.pop("stream")
    bw = lab_stream.stream_bytes(s_big) / t_stream
    print(f"stream: {t_stream * 1e6:7.2f} us  {bw / 1e9:6.1f} GB/s (L2 flushed)", flush=True)
    for name, t in res.items():
        floor = S * D * (2 if " bf16 " in name else 4) / bw
        print(f"{name}: {t * 1e6:7.2f} us  frac_vs_stream={floor / t:5.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
