#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nwhead_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or without the
package beside it. With one, in order:

1. prints the card (nvidia-smi name and power limit, compute capability) and
   ``nwhead_tpu_torch.capabilities()``;
2. builds the CUDA kernel library from ``nwhead_tpu_torch/csrc`` with nvcc
   and prints the build time and ptxas's register/shared-memory report;
3. kernel phase: the prepared NW head kernel against its plain PyTorch
   version, all five similarity kernels, f32 and bf16 banks with masked rows,
   at the CUB-200 shape (B=64, S=5994, D=512, C=200), at B=256, at a ragged
   B=37 and at C=10; times kernel and plain version with CUDA events;
4. slice phase: ``python -m nwhead_tpu_torch.serve --dataset synthetic_cub
   --arch resnet18 --batch_size 64 --latency_bench``, through the serve
   module's functions, with an f32 and then a bf16 head. It checks that the
   kernel was launched, and that the served log-probs equal the plain head's
   on the same features;
5. prints the nvidia-smi line, a JSON line of per-kernel results, and as the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Tolerances of kernel vs plain PyTorch on the card: f32 as the JAX kernel is
# held to its naive op (tests/test_pallas_nw.py); bf16 banks differ from the
# plain version only in the f32 summation order of bf16 products.
TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}
KERNEL_CASES = (  # name, B, S, D, C
    ("cub_b64", 64, 5994, 512, 200),
    ("cub_b256", 256, 5994, 512, 200),
    ("ragged_b37", 37, 5994, 512, 200),
    ("c10_b64", 64, 5994, 512, 10),
)
SOURCE = "nwhead_tpu_torch/csrc/nw_prepared.cu"
REPLACES = "nwhead_tpu/ops/pallas_nw.py:820"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def within(got, want, rtol, atol) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def time_ms(fn, flush, n=30) -> float:
    """Median device time of one call, with L2 flushed before each (the
    serving loop runs the featurizer between head calls), by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def kernel_phase(flush) -> dict:
    """Kernel vs plain at each case; returns per-precision max |err| and the
    CUB B=64 euclidean times."""
    import torch

    from nwhead_tpu_torch.ops.fused_nw import (
        _nw_prepared_plain, _resolve_mode, nw_prepared_cuda, prepare_support,
    )
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    res = {p: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for p in TOL}
    for ci, (case, B, S, D, C) in enumerate(KERNEL_CASES):
        rng = np.random.default_rng(ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        sy = rng.integers(0, C, size=S)
        mask = torch.from_numpy((rng.random(S) > 0.03).astype(np.float32))
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec in TOL:
                prep = prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                       precision=prec)
                mode, scale, qn, _ = _resolve_mode(kernel, params, q)
                qc = qn.to(prep.s.dtype)
                got = nw_prepared_cuda(qc, prep, scale, mode, C)
                want = _nw_prepared_plain(qc, prep, scale, mode, C)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and within(got, want, **TOL[prec])
                print(f"kernel {case} {kernel} {prec}: max|err| {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: {case} {kernel} {prec}")
                res[prec]["max_abs_err"] = max(res[prec]["max_abs_err"], err)
                if case == "cub_b64" and kernel == "euclidean":
                    res[prec]["ms"] = time_ms(
                        lambda: nw_prepared_cuda(qc, prep, scale, mode, C), flush)
                    res[prec]["plain_ms"] = time_ms(
                        lambda: _nw_prepared_plain(qc, prep, scale, mode, C), flush)
                    print(f"time {case} {kernel} {prec}: kernel {res[prec]['ms']:.4f} ms, "
                          f"plain {res[prec]['plain_ms']:.4f} ms")
    return res


def slice_phase() -> dict:
    """The serving CLI's path at the CUB recipe's scale, f32 then bf16 head.
    Returns the kernel's launch count and the latency report per head."""
    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.ops.fused_nw import (
        _nw_prepared_plain, _resolve_mode, nw_prepared_cuda,
    )

    args = serve.parse_args([
        "--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64",
        "--latency_bench",
    ])
    t0 = time.perf_counter()
    train_ds, val_ds = serve.build_datasets(args)
    print(f"datasets built in {time.perf_counter() - t0:.1f}s")
    out = {}
    for prec in TOL:
        args.head_precision = prec
        nw_prepared_cuda.launches = 0
        net = serve.build_server(args, train_ds)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = nw_prepared_cuda.launches
        if launches == 0:
            raise AssertionError(f"{prec}: the serving path never launched the kernel")

        x = val_ds.gather(np.arange(args.batch_size))
        served = net.make_serving_fn()(x)
        with torch.inference_mode():
            prep = net._prepared_full
            feats = net.model.featurize(torch.from_numpy(x).to(net.device))
            mode, scale, qn, _ = _resolve_mode(
                net.kernel_type, net.model.head.kernel_params(), feats)
            plain = _nw_prepared_plain(qn.to(prep.s.dtype), prep, scale, mode,
                                       net.n_classes)
        torch.cuda.synchronize()
        err = float((served - plain).abs().max())
        mass = float((served.exp().sum(1) - 1).abs().max())
        S = prep.s.shape[0]
        print(f"slice {prec}: bank S={S} D={prep.s.shape[1]} C={net.n_classes}; "
              f"launches {launches}; served vs plain max|err| {err:.3e}; "
              f"|sum p - 1| {mass:.2e}; p50 {report['p50_ms']:.3f} ms, "
              f"p95 {report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s")
        if tuple(served.shape) != (args.batch_size, net.n_classes):
            raise AssertionError(f"served shape {tuple(served.shape)}")
        if not bool(torch.isfinite(served).all()):
            raise AssertionError("served log-probs are not finite")
        if not within(served, plain, **TOL[prec]) or mass > 1e-3:
            raise AssertionError(f"{prec}: served log-probs disagree with the plain head")
        out[prec] = {"launches": launches, "report": report, "served_err": err}
        del net
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import nwhead_tpu_torch
    from nwhead_tpu_torch.ops import _cuda

    print(nvidia_smi_line())
    print(f"device: {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"capabilities: {json.dumps(nwhead_tpu_torch.capabilities())}")

    info = _cuda.build()
    print(f"build: {'cached' if info['cached'] else 'compiled'} in "
          f"{info['seconds']:.1f}s -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
            print(f"  ptxas: {line.strip()}")
    lib = _cuda.load_library()
    print(f"  shared memory per pass-1 block: {lib.nw_prepared_smem_bytes(200)} bytes "
          f"(dynamic) at C=200; largest C on this card: {lib.nw_prepared_max_classes(0)}")

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    kern = kernel_phase(flush)
    del flush
    sl = slice_phase()

    print(nvidia_smi_line())
    print(json.dumps({"kernels": [
        {"name": f"nw_prepared_{p}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": sl[p]["launches"],
         "max_abs_err": max(kern[p]["max_abs_err"], sl[p]["served_err"]),
         "ms": kern[p]["ms"], "plain_ms": kern[p]["plain_ms"]}
        for p in TOL
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
