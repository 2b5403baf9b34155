"""NW-head serving CLI of the port: build the server, time requests.

Port of the serving path of the root ``serve.py`` (``build_server``,
``latency_bench``) with the synthetic datasets of ``train.py``. Weights are
random, from ``--seed``. Run as::

    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch vit_s14 \
        --featurizer_precision bf16_fused --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch vit_s14 \
        --fused_inference --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch vit_s14 \
        --featurizer_precision int8 --head_precision int8 --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --serve_mode ivf --ivf_probe auto --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --mesh 1,1 --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet50 \
        --pretrained_path resnet50.pth --head_precision bf16 --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet50 \
        --featurizer_precision int8 --head_precision int8 --batch_size 64 --latency_bench

``--featurizer_precision bf16_fused`` serves a ViT through the bf16
fused-serving graph (K10/K11 per block); ``--featurizer_precision int8``
through the int8 post-training-quantized one (a ViT's K10 int8 and K11 int8
per block; an ImageNet ResNet's, ResNeXt's or DenseNet's int8 convs,
``ops/int8_conv.py``, around a bf16 stem), calibrated on the first
``--calib_images`` training images before the bank is built; ``--fused_inference`` runs a ViT's attention and MLP on
K7 and K9; ``--bf16`` computes the featurizer in bf16 (a ViT, or a CNN with
its BatchNorm statistics in f32); ``--pretrained_path`` merges a local
torchvision- or DINOv2-format checkpoint into the backbone (``--arch`` takes
any registry name: ``resnet50``, ``densenet121``, ...). ``--head_precision`` picks the
prepared bank: f32 or bf16 (K2), int8 (K4) or int4 (K5). ``--serve_mode ivf``
serves through the IVF-pruned head (``ops/ivf.py``, K6 over the bank tiles
each batch routes to): ``--ivf_probe`` tiles per query (``auto``: calibrated
against the exact head on ``min(256, len(val))`` validation images before
the timed loop), ``--ivf_group`` queries per routed group. ``--mesh
N_DATA,N_SUPPORT`` serves from a support-sharded bank
(``parallel.ShardedSupportBank``) on a mesh of the first ``N_DATA *
N_SUPPORT`` CUDA devices, or with ``--device cpu`` of that many virtual CPU
devices; the batch splits over the data axis, and each shard runs the
head's partials (K2/K4/K5 ``partials=True``, K6 under ``--serve_mode ivf``).

``--device`` defaults to ``cuda``; with no CUDA device that is an error, and
the CPU must be asked for (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
from nwhead_tpu_torch.models import VIT_NAMES, load_model
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.parallel import make_mesh


def build_datasets(args):
    """(train, val) for ``--dataset``: ``synthetic`` (64/32 images of 32 px,
    4 classes) or ``synthetic_cub`` (the CUB-200 recipe's scale: 5994/1000
    images of 224 px, 200 classes, about 3.6 GB of f32)."""
    if args.dataset == "synthetic":
        return (make_synthetic_dataset(n=64, n_classes=4, size=32, seed=args.seed),
                make_synthetic_dataset(n=32, n_classes=4, size=32, seed=args.seed + 1))
    if args.dataset == "synthetic_cub":
        return (make_synthetic_dataset(n=5994, n_classes=200, size=224, seed=args.seed,
                                       class_patterns=0.25),
                make_synthetic_dataset(n=1000, n_classes=200, size=224, seed=args.seed + 1,
                                       class_patterns=0.25))
    raise NotImplementedError(
        f"dataset {args.dataset!r} is not ported yet (ROADMAP.md queue 1, item 11)"
    )


def device_info(device: torch.device) -> dict:
    """The device's name and, for a GPU, its power limit as nvidia-smi
    reports it (times depend on it)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip() or None
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}


def featurizer_options(args) -> dict:
    """``load_model`` options from the featurizer flags (``--bf16``: any
    backbone in bf16; ``--pretrained_path``: a local checkpoint merged at
    build time); refuses what is not ported or does not apply (the JAX
    CLI's message for ``--fused_inference`` on a CNN)."""
    vit = args.arch in VIT_NAMES
    if args.featurizer_precision == "bf16_fused" and not vit:
        raise NotImplementedError(
            f"--featurizer_precision bf16_fused with --arch {args.arch}: the bf16 "
            "fused-serving graph is ViT-only, as in the JAX package; a CNN computes in bf16 "
            "with --bf16")
    if args.fused_inference and not vit:
        raise SystemExit("--fused_inference applies to ViT archs only")
    opts = {}
    if args.bf16:
        opts["dtype"] = torch.bfloat16
    if args.fused_inference:
        opts.update(attn_impl="fused", mlp_impl="fused")
    if args.pretrained_path:
        opts["pretrained"] = args.pretrained_path
    return opts


def build_mesh(args, device: torch.device):
    """``--mesh N_DATA,N_SUPPORT[,N_MODEL]`` as a mesh (None when unset), as
    the JAX CLI parses it (``train.py:build_mesh``): the first ``n`` CUDA
    devices, or ``n`` copies of the CPU with ``--device cpu`` (the virtual
    devices of the JAX package's CPU meshes)."""
    if not args.mesh:
        return None
    dims = [int(x) for x in args.mesh.split(",")]
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {args.mesh}: need N_DATA,N_SUPPORT[,N_MODEL]")
    n = math.prod(dims)
    if device.type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"--mesh {args.mesh} needs {n} devices, have "
                             f"{torch.cuda.device_count()}")
        return make_mesh(*dims, devices=[torch.device("cuda", i) for i in range(n)])
    return make_mesh(*dims, devices=[device] * n)


def build_server(args, train_ds, edit=None, val_ds=None) -> NWNet:
    """An ``NWNet`` with random weights from ``--seed``, its featurizer
    fused for ``--featurizer_precision bf16_fused`` or quantized and
    calibrated on the first ``--calib_images`` training images for
    ``int8``, its full support bank featurized and prepared for the fused
    head whatever its size (the JAX serving CLI's ``fused_min_support=1``).
    ``edit(net)``, when given, runs before the featurizer is fused or
    quantized and the bank built (``chip_smoke.py`` sets the LayerScale
    gammas there). The calibration's and the bank's seconds are kept in
    ``net.calibration_seconds`` (0 without calibration) and
    ``net.precompute_seconds``. ``--serve_mode ivf --ivf_probe auto``
    calibrates the IVF knobs on the first ``min(256, len(val_ds))``
    validation images. ``--mesh`` attaches a mesh: the bank is sharded over
    its support axis."""
    if args.serve_mode == "ivf" and args.ivf_probe == "auto" and val_ds is None:
        raise ValueError("--ivf_probe auto calibrates on validation images: pass val_ds")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu to run on the CPU)")
    mesh = build_mesh(args, device)
    featurizer = load_model(args.arch, device=device,
                            generator=torch.Generator().manual_seed(args.seed),
                            **featurizer_options(args))
    net = NWNet(
        featurizer, train_ds.num_classes, support_dataset=train_ds, device=device,
        kernel_type=args.kernel_type, n_shot_full=args.n_shot_full,
        head_precision=args.head_precision, fused_min_support=1,
        ivf_n_probe=args.ivf_probe, ivf_group_b=args.ivf_group, mesh=mesh,
    )
    if edit is not None:
        edit(net)
    net.calibration_seconds = 0.0
    if args.featurizer_precision == "int8":
        t0 = time.perf_counter()
        n_cal = min(args.calib_images, len(train_ds))
        net.quantize_featurizer(train_ds.gather(np.arange(n_cal)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        net.calibration_seconds = time.perf_counter() - t0
        print(f"Quantized featurizer (int8 PTQ, {n_cal} calibration images, "
              f"{net.calibration_seconds:.1f}s)")
    elif args.featurizer_precision == "bf16_fused":
        net.fuse_featurizer()
        print("Fused featurizer (bf16 serving graph, LN/residual folded)")
    t0 = time.perf_counter()
    net.precompute()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    net.precompute_seconds = time.perf_counter() - t0
    sharded = "" if mesh is None else f" in {mesh.shape['support']} shards on mesh {mesh.shape}"
    print(f"Support bank prepared: {len(net.full_y)} items{sharded}, "
          f"{net.precompute_seconds:.1f}s (one-time)")
    if args.serve_mode == "ivf" and args.ivf_probe == "auto":
        # Before any serving callable fixes the knobs (make_serving_fn
        # raises on an unresolved 'auto').
        n_cal = min(256, len(val_ds))
        cfg = net.calibrate_ivf(x=val_ds.gather(np.arange(n_cal)))
        print(f"IVF auto-calibrated on {n_cal} val queries: n_probe={cfg.n_probe} "
              f"group_b={cfg.group_b} top-1 agreement {cfg.agreement:.4f} "
              f"(route diversity {cfg.route_diversity})")
    return net


def latency_bench(net: NWNet, val_ds, args) -> dict:
    """Wall-clock latency per request of ``--batch_size`` images, host
    arrays in, log-probs back on the host: the time a caller sees."""
    bs = args.batch_size
    n = min(args.bench_batches, max(1, len(val_ds) // bs))
    serve = net.make_serving_fn(mode=args.serve_mode)
    warm = val_ds.gather(np.arange(bs) % len(val_ds))
    for _ in range(3):
        serve(warm).cpu()
    lat = []
    for i in range(n):
        batch = val_ds.gather((np.arange(bs) + i * bs) % len(val_ds))
        t0 = time.perf_counter()
        serve(batch).cpu()  # readback: the request is complete
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    report = {
        "batch_size": bs,
        "batches": n,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "mean_ms": float(lat_ms.mean()),
        "queries_per_sec": bs / float(np.median(lat)),
        "arch": args.arch,
        "featurizer_precision": args.featurizer_precision,
        "fused_inference": bool(args.fused_inference),
        "bf16": bool(args.bf16),
        "pretrained_path": args.pretrained_path,
        "head_precision": args.head_precision,
        "serve_mode": args.serve_mode,
        "mesh": None if net.mesh is None else net.mesh.shape,
        "device": device_info(net.device),
    }
    if args.serve_mode == "ivf":
        report.update(ivf_probe=net.ivf_n_probe, ivf_group=net.ivf_group_b)
    print(json.dumps(report))
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NW head serving (PyTorch/CUDA port)")
    p.add_argument("--dataset", required=True, choices=["synthetic", "synthetic_cub"])
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--kernel_type", default="euclidean")
    p.add_argument("--n_shot_full", type=int, default=100)
    p.add_argument("--head_precision", default="f32", choices=["f32", "bf16", "int8", "int4"],
                   help="the prepared bank: f32/bf16 (K2), int8 (K4) or int4 (K5)")
    p.add_argument("--featurizer_precision", default="f32", choices=["f32", "int8", "bf16_fused"],
                   help="int8: the int8 post-training-quantized featurizer (a ViT's K10/K11 "
                        "int8, a ResNet's, ResNeXt's or DenseNet's int8 convs); bf16_fused: a "
                        "ViT's bf16 fused-serving graph (K10/K11)")
    p.add_argument("--calib_images", type=int, default=256,
                   help="training images that calibrate --featurizer_precision int8")
    p.add_argument("--fused_inference", action="store_true",
                   help="a ViT's attention and MLP on the fused kernels K7 and K9")
    p.add_argument("--bf16", action="store_true",
                   help="compute the featurizer in bf16 (flax's mixed precision: f32 "
                        "parameters, BatchNorm statistics in f32)")
    p.add_argument("--pretrained_path", default=None,
                   help="a local torchvision- or DINOv2-format checkpoint (.pth/.pt/.npz) "
                        "merged into the backbone at build time")
    p.add_argument("--serve_mode", default="full", choices=["full", "ivf"],
                   help="the head per request: 'full' streams the whole prepared bank "
                        "(exact); 'ivf' routes each batch to its top tiles and streams only "
                        "those (K6)")
    p.add_argument("--ivf_probe", type=lambda v: v if v == "auto" else int(v), default=32,
                   help="--serve_mode ivf: routed tiles per query before the batch union "
                        "(at least the bank's tile count reproduces full mode); 'auto' "
                        "calibrates it against the exact head on validation images")
    p.add_argument("--ivf_group", type=int, default=None,
                   help="--serve_mode ivf: route-sort each batch and give every IVF_GROUP "
                        "queries their own tile union (default: one union per batch)")
    p.add_argument("--mesh", default=None,
                   help="'N_DATA,N_SUPPORT[,N_MODEL]': serve from a bank sharded over "
                        "N_SUPPORT devices, the batch split over N_DATA (N_MODEL must be 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latency_bench", action="store_true")
    p.add_argument("--bench_batches", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.latency_bench:
        raise SystemExit("pass --latency_bench")
    featurizer_options(args)  # refuse before the datasets are drawn
    train_ds, val_ds = build_datasets(args)
    net = build_server(args, train_ds, val_ds=val_ds)
    return {"latency": latency_bench(net, val_ds, args)}


if __name__ == "__main__":
    main()
