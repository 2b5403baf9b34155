"""NW-head serving CLI of the port: build the server, then answer queries,
serve HTTP or time requests.

Port of the root ``serve.py`` with the datasets of the training CLI
(``--data_dir``, ``--workers``, ``--decoder``, by default ``native_fused``:
the C++ libjpeg pool decodes, crops and resizes in one pass; ``pil`` where
there is no libjpeg). The weights are random, from ``--seed``, or a
checkpoint of the port's training CLI (``--ckpt``, loaded before any
quantize or fuse), with an optional ``--proj_dim`` projection. The
image-file datasets' requests ship uint8 pixels, normalized on the device
inside the serving callable (``make_serving_fn(normalize=)``); CIFAR's and
the in-memory sets' ship float32. ``--bank_cache DIR`` saves the featurized
bank with a tag of what computed it, and a later server with the same tag
restores it instead of featurizing the support set; a server with another
tag refuses the cache. The tag is the JAX server's plus ``"package"``, so a
cache the JAX server wrote (other weights from the same seed) is refused.

The actions (any of them in one run, or ``--http`` alone):

* ``--latency_bench``: B = ``--batch_size`` requests, one client, p50/p95;
* ``--microbatch_bench``: ``--concurrency`` clients send one image a
  request through ``utils.batching.MicroBatcher`` (``--microbatch_wait_ms``):
  qps, request p50/p95 and the batches' mean occupancy;
* ``--jpeg_bench``: JPEG files in, answers out, by stage
  (``utils.pipeline.jpeg_stage_rates``: decode, copy, device, pipelined);
* ``--queries GLOB``: classify image files (``--topk``, ``--temperature``),
  with ``--explain K`` each answer's K heaviest support rows and its most
  helpful and most harmful rows by leave-one-out influence;
* ``--http PORT``: the JSON-over-HTTP daemon (``utils.httpd``): predict,
  add and remove support rows live, health and stats.

``--export_artifact DIR`` exports the serving callable as an AOT artifact
(``utils/aot.py``: a ``torch.export`` program with its weights and bank,
uint8 pixels in with the imagenet normalization folded in, CIFAR's floats;
under ``--mesh`` the mesh program) and exits; ``--serve_artifact DIR``
loads one with no model build and no dataset and answers
``--latency_bench`` and ``--queries``. Run as::

    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --ckpt run/checkpoints/model.0001 --queries 'photos/*.jpg' --topk 3 --explain 5 \
        --decoder pil
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --microbatch_bench --concurrency 16 --bench_batches 2
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --jpeg_bench --decoder pil --workers 8 --bench_batches 4
    python -m nwhead_tpu_torch.serve --dataset cifar100 --data_dir data \
        --arch CIFAR_ResNet18 --http 8080
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
    python -m nwhead_tpu_torch.serve --dataset cifar100 --data_dir data \
        --arch CIFAR_ResNet18 --bank_cache bank_dir --batch_size 64 --latency_bench
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch resnet18 \
        --batch_size 64 --export_artifact art_dir
    python -m nwhead_tpu_torch.serve --dataset synthetic_cub --serve_artifact art_dir \
        --latency_bench

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
import glob
import json
import math
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from nwhead_tpu_torch.data import transforms as T
from nwhead_tpu_torch.data.datasets import ImageFileDataset, draw_init_sample
from nwhead_tpu_torch.data.embedding_cache import FeatureBankCache
from nwhead_tpu_torch.models import VIT_NAMES, load_model
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops.calibrate import apply_temperature
from nwhead_tpu_torch.ops.influence import support_influence
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES
from nwhead_tpu_torch.parallel import make_mesh
from nwhead_tpu_torch.train import build_datasets  # (train, val), as the training CLI's
from nwhead_tpu_torch.train.checkpoint import load_checkpoint
from nwhead_tpu_torch.train.config import CIFAR_DATASETS, DATASETS
from nwhead_tpu_torch.utils.batching import MicroBatcher
from nwhead_tpu_torch.utils.httpd import NWHttpServer
from nwhead_tpu_torch.utils.pipeline import jpeg_stage_rates, photo_jpegs

# The image-file datasets: their requests ship uint8 pixels (JAX serve.py:441).
IMAGE_DATASETS = ("bird", "dog", "flower", "aircraft")


def uint8_requests(ds):
    """The dataset's images as a server receives them: for an image-file
    dataset the same files through the imagenet eval transform stopped
    before normalizing (uint8), with ``(mean, std)`` for the device;
    ``(ds, None)`` for any other."""
    if not isinstance(ds, ImageFileDataset):
        return ds, None
    return (ImageFileDataset(ds.paths, ds.targets, ds.num_classes,
                             transform=T.imagenet_eval_transform(device_normalize=True),
                             workers=ds.workers, decoder=ds.decoder),
            (T.IMAGENET_MEAN, T.IMAGENET_STD))


def bank_tag(args) -> dict:
    """What a cached bank's features depend on: the JAX server's tag
    (``ckpt`` the checkpoint's path, ``seed`` empty with one, as JAX
    ``serve.py:107-112``) plus the package, since the two packages draw
    different weights from one seed."""
    return {
        "dataset": args.dataset,
        "arch": args.arch,
        "ckpt": args.ckpt or "",
        "pretrained_path": args.pretrained_path or "",
        "seed": "" if args.ckpt else str(args.seed),
        "featurizer_precision": args.featurizer_precision,
        "bf16": str(bool(args.bf16)),
        "fused_inference": str(bool(args.fused_inference)),
        "calib_images": str(args.calib_images),
        "proj_dim": str(args.proj_dim),
        "n_shot_full": str(args.n_shot_full),
        "package": "nwhead_tpu_torch",
    }


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
    """An ``NWNet`` with random weights from ``--seed`` (a ``--proj_dim``
    projection too) or, with ``--ckpt``, a checkpoint of the port's
    training CLI loaded over them (its ``"model"`` state, as the eval CLI
    loads it), its featurizer
    fused for ``--featurizer_precision bf16_fused`` or quantized and
    calibrated on the first ``--calib_images`` training images for
    ``int8``, its full support bank featurized and prepared for the fused
    head whatever its size (the JAX serving CLI's ``fused_min_support=1``).
    ``edit(net)``, when given, runs before the featurizer is fused or
    quantized and the bank built (``chip_smoke.py`` sets the LayerScale
    gammas there). With ``--bank_cache`` the bank is restored from the
    cache when it holds one with this server's ``bank_tag`` (another tag
    exits), else featurized and saved there with the tag. The
    calibration's and the bank's seconds are kept in
    ``net.calibration_seconds`` (0 without calibration) and
    ``net.precompute_seconds`` (the restore's, reading the files included,
    when ``net.bank_restored``). ``--serve_mode ivf --ivf_probe auto``
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
        feat_dim=featurizer.feat_dim, proj_dim=args.proj_dim,
        kernel_type=args.kernel_type, n_shot_full=args.n_shot_full,
        head_precision=args.head_precision, fused_min_support=1, seed=args.seed,
        ivf_n_probe=args.ivf_probe, ivf_group_b=args.ivf_group, mesh=mesh,
    )
    draw_init_sample(train_ds, args.batch_size)
    if args.ckpt:
        net.model.load_state_dict(load_checkpoint(args.ckpt)["model"])
        print(f"Loaded checkpoint {args.ckpt}")
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
    cache = FeatureBankCache(args.bank_cache) if args.bank_cache else None
    tag = bank_tag(args)
    net.bank_restored = cache is not None and cache.exists()
    t0 = time.perf_counter()
    if net.bank_restored:
        saved = cache.load_tag()
        if saved != tag:
            raise SystemExit(f"--bank_cache {args.bank_cache} was built with {saved}, this "
                             f"server is {tag}; use a fresh cache dir")
        net.restore_bank(*cache.load())
    else:
        net.precompute()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    net.precompute_seconds = time.perf_counter() - t0
    if cache is not None and not net.bank_restored:
        cache.save(net.full_feat.cpu().numpy(), net.full_y.cpu().numpy(),
                   metadata=net.support_eval.full_meta, tag=tag)
        print(f"Saved bank to {args.bank_cache}")
    sharded = "" if mesh is None else f" in {mesh.shape['support']} shards on mesh {mesh.shape}"
    how = f"restored from {args.bank_cache}" if net.bank_restored else "prepared"
    print(f"Support bank {how}: {len(net.full_y)} items{sharded}, "
          f"{net.precompute_seconds:.3f}s (one-time)")
    if args.serve_mode == "ivf" and args.ivf_probe == "auto":
        # Before any serving callable fixes the knobs (make_serving_fn
        # raises on an unresolved 'auto').
        n_cal = min(256, len(val_ds))
        cfg = net.calibrate_ivf(x=val_ds.gather(np.arange(n_cal)))
        print(f"IVF auto-calibrated on {n_cal} val queries: n_probe={cfg.n_probe} "
              f"group_b={cfg.group_b} top-1 agreement {cfg.agreement:.4f} "
              f"(route diversity {cfg.route_diversity})")
    return net


def serving_fn(net: NWNet, uint8_normalize: bool = False, mode: str = "full"):
    """The per-request callable ``(B, H, W, C) -> (B, C)`` log-probs on the
    net's device. A kernel of ``KERNEL_NAMES`` serves through
    ``net.make_serving_fn`` (normalize, featurize, the prepared or sharded
    bank's kernel; ``mode="ivf"`` the IVF-pruned head), whose errors
    propagate; any other kernel (``relation``), which has no fused route in
    either package, through ``net.predict(x, "full")``.
    ``uint8_normalize``: the requests are uint8 pixels, normalized on the
    device with the imagenet statistics."""
    if net.kernel_type in KERNEL_NAMES:
        stats = (T.IMAGENET_MEAN, T.IMAGENET_STD) if uint8_normalize else None
        return net.make_serving_fn(normalize=stats, mode=mode)
    if mode != "full":
        raise ValueError(f"--serve_mode {mode} needs a fused kernel ({', '.join(KERNEL_NAMES)}), "
                         f"not {net.kernel_type!r}")
    norm = T.device_normalize_fn() if uint8_normalize else None

    def serve(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(net.device)
        if norm is not None and x.dtype == torch.uint8:
            x = norm(x)
        out = net.predict(x, "full")
        return out[0] if isinstance(out, tuple) else out

    return serve


def latency_bench(net: NWNet, val_ds, args) -> dict:
    """Wall-clock latency per request of ``--batch_size`` images, host
    arrays in (uint8 for an image-file dataset, normalized on the device),
    log-probs back on the host: the time a caller sees."""
    bs = args.batch_size
    n = min(args.bench_batches, max(1, len(val_ds) // bs))
    val_ds, stats = uint8_requests(val_ds)
    serve = serving_fn(net, uint8_normalize=stats is not None, mode=args.serve_mode)
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
        "pixels": "float32" if stats is None else "uint8",
        "bank_restored": bool(getattr(net, "bank_restored", False)),
        "mesh": None if net.mesh is None else net.mesh.shape,
        "device": device_info(net.device),
    }
    if args.serve_mode == "ivf":
        report.update(ivf_probe=net.ivf_n_probe, ivf_group=net.ivf_group_b)
    print(json.dumps(report))
    return report


def microbatch_bench(net: NWNet, val_ds, args) -> dict:
    """One image a request through the ``MicroBatcher``: ``--concurrency``
    client threads each send ``max(2, --bench_batches) * max(4, B // 2)``
    single images in a closed loop (B = ``--batch_size``, the batch the
    device serves, ``--microbatch_wait_ms`` the batcher's wait). Reports the
    achieved queries/s, each request's latency (submit to result: the wait
    to fill a batch, the device, the readback) and the batches' mean
    occupancy from the batcher's own counters: how well one-image traffic
    fills the batch."""
    bs = args.batch_size
    val_ds, stats = uint8_requests(val_ds)
    serve = serving_fn(net, uint8_normalize=stats is not None, mode=args.serve_mode)
    imgs = val_ds.gather(np.arange(min(64, len(val_ds))))
    serve(np.repeat(imgs[:1], bs, axis=0)).cpu()  # warm at the batch shape
    requests = max(2, args.bench_batches) * max(4, bs // 2)
    lat, lat_lock = [], threading.Lock()
    with MicroBatcher(serve, max_batch=bs, max_wait_ms=args.microbatch_wait_ms) as mb:
        def client(c: int) -> None:
            mine = []
            for r in range(requests):
                x = imgs[(c + r) % len(imgs)]
                t0 = time.perf_counter()
                mb.submit(x).result(timeout=120)
                mine.append(time.perf_counter() - t0)
            with lat_lock:
                lat.extend(mine)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(args.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    if len(lat) != args.concurrency * requests:
        raise RuntimeError(f"{len(lat)} of {args.concurrency * requests} requests were "
                           "answered (a client thread failed)")
    lat_ms = np.asarray(lat) * 1e3
    report = {
        "concurrency": args.concurrency,
        "compiled_batch": bs,
        "max_wait_ms": args.microbatch_wait_ms,
        "requests": len(lat),
        "achieved_qps": len(lat) / wall,
        "request_p50_ms": float(np.percentile(lat_ms, 50)),
        "request_p95_ms": float(np.percentile(lat_ms, 95)),
        "mean_batch_occupancy": mb.dispatched_items / mb.dispatches,
        "batches_dispatched": mb.dispatches,
        "pixels": "float32" if stats is None else "uint8",
        "device": device_info(net.device),
    }
    print(json.dumps(report))
    return report


def jpeg_bench(net: NWNet, train_ds, args) -> dict:
    """Images in, answers out, from JPEG files: ``--queries``' files, or
    ``min(256, --bench_batches * B)`` photo-sized JPEGs written for the run
    (``utils.pipeline.photo_jpegs``: photographs where sklearn is
    installed, else mosaics; removed afterwards), decoded by ``--decoder``
    with ``--workers`` threads through the eval transform (uint8 pixels,
    normalized on the device; CIFAR's floats) and served by the serving
    callable. The stages are timed alone and pipelined
    (``utils.pipeline.jpeg_stage_rates``), so the one that binds is
    named."""
    bs, nb = args.batch_size, args.bench_batches
    is_cifar = args.dataset in CIFAR_DATASETS
    t_eval = (T.cifar_eval_transform() if is_cifar
              else T.imagenet_eval_transform(device_normalize=True))
    with tempfile.TemporaryDirectory(prefix="nw_jpeg_bench_") as tmp:
        if args.queries:
            paths, source = sorted(glob.glob(args.queries)), "user files"
            if not paths:
                raise SystemExit(f"no files match {args.queries!r}")
        else:
            paths, source = photo_jpegs(min(256, nb * bs), dir=tmp)
        ds = ImageFileDataset(paths, np.zeros(len(paths), np.int64), train_ds.num_classes,
                              transform=t_eval, workers=args.workers, decoder=args.decoder)

        def batch(i):
            return ds.gather((np.arange(bs) + i * bs) % len(ds))

        serve = serving_fn(net, uint8_normalize=not is_cifar, mode=args.serve_mode)
        rates = jpeg_stage_rates(batch, serve, nb, bs, net.device)
    report = {
        "batch_size": bs,
        "batches": nb,
        "jpeg_hw": "user files" if args.queries else "480x640",
        "jpeg_source": source,
        "decode_workers": args.workers,
        "decoder": args.decoder,
        "pixel_transfer": "f32" if is_cifar else "uint8",
        **rates,
        "featurizer_precision": args.featurizer_precision,
        "head_precision": args.head_precision,
        "device": device_info(net.device),
    }
    print(json.dumps(report))
    return report


def answer_queries(net: NWNet, train_ds, args) -> list:
    """Classify the files of ``--queries`` in chunks of ``--batch_size``:
    each file's ``--topk`` classes with their probabilities (after
    ``--temperature``), one JSON line each. Every chunk is padded to the
    batch with zero images (one batch shape; under ``--mesh`` the batch
    must divide the data axis) and the padding rows dropped. With
    ``--explain K`` the answers come from the exact f32 head over the raw
    bank on host-normalized pixels, with each query's explanation
    (``_build_explainer``); otherwise from the serving callable on uint8
    pixels (CIFAR's floats)."""
    paths = sorted(glob.glob(args.queries))
    if not paths:
        raise SystemExit(f"no files match {args.queries!r}")
    is_cifar = args.dataset in CIFAR_DATASETS
    explain = args.explain
    t_eval = (T.cifar_eval_transform() if is_cifar
              else T.imagenet_eval_transform(device_normalize=not explain))
    qds = ImageFileDataset(paths, np.zeros(len(paths), np.int64), train_ds.num_classes,
                           transform=t_eval, workers=args.workers, decoder=args.decoder)
    if explain:
        if args.head_precision != "f32":
            print(f"note: --explain answers use the exact f32 raw head; the "
                  f"{args.head_precision} prepared bank serves only unexplained paths",
                  flush=True)
        explain_fn = _build_explainer(net, train_ds)
    else:
        serve = serving_fn(net, uint8_normalize=not is_cifar, mode=args.serve_mode)
    results = []
    for start in range(0, len(paths), args.batch_size):
        chunk = paths[start:start + args.batch_size]
        imgs = qds.gather(np.arange(start, start + len(chunk)))
        pad = args.batch_size - len(chunk)
        if pad > 0:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
        explanations = None
        if explain:
            out, explanations = explain_fn(imgs, explain)
            out, explanations = out[:len(chunk)], explanations[:len(chunk)]
        else:
            out = serve(imgs).cpu().numpy()[:len(chunk)]
        if args.temperature != 1.0:
            # Post-hoc calibration: the probabilities change, the order does not.
            out = apply_temperature(out, args.temperature).numpy()
        top = np.argsort(-out, axis=-1)[:, :args.topk]
        for i, (p, t, lp) in enumerate(zip(chunk, top, out)):
            entry = {"file": p,
                     "topk": [{"class": int(c), "prob": round(float(np.exp(lp[c])), 4)}
                              for c in t]}
            if explanations is not None:
                entry["explain"] = explanations[i]
            results.append(entry)
            print(json.dumps(entry))
    return results


def _build_explainer(net: NWNet, train_ds):
    """Explanations from the NW head's own weights (the reference's
    neighbours, ``nw.py:245-249``, and leave-one-out influence,
    ``util/metric.py:23-50``): a callable ``(imgs, k) -> (log_probs,
    [explanation])``. One featurizer pass and the naive f32 head over the
    whole bank (``NWHead.probs_and_weights``) give the answer,
    ``log(probs + 1e-12)``, and its explanation: the ``k`` bank rows of
    largest softmax weight, the (at most ``k``) rows of largest positive
    influence on the predicted class, and the row of most negative
    influence when one is negative (``ops/influence.support_influence``).
    A row carries its bank index and label and, while the bank is in
    ``precompute``'s order (``bank_is_canonical``: an edit clears it), its
    index in the support dataset (and the file's path for an image-file
    dataset)."""
    bank_to_ds = np.concatenate(net.support_eval.full_bank_indices)
    if (not getattr(net.support_eval, "bank_is_canonical", False)
            or len(bank_to_ds) != len(net.full_y)):
        bank_to_ds = None
    spaths = getattr(train_ds, "paths", None)
    sy = torch.as_tensor(net.full_y, device=net.device)
    sy_np = sy.cpu().numpy()

    def item(row, value, key):
        d = {"support_index": int(row), "label": int(sy_np[row]), key: round(float(value), 6)}
        if bank_to_ds is not None:
            ds_idx = int(bank_to_ds[row])
            d["dataset_index"] = ds_idx
            if spaths is not None:
                d["path"] = str(spaths[ds_idx])
        return d

    @torch.inference_mode()
    def run(imgs, k):
        net.model.eval()
        qfeat = net._featurize_eval(torch.as_tensor(imgs).to(net.device, torch.float32))
        probs, weights = net.model.head.probs_and_weights(qfeat, net.full_feat, sy)
        pred = probs.argmax(dim=-1)
        # Positive: the row pushed toward this answer (removing it would hurt).
        infl = support_influence(probs, pred, weights, sy).cpu().numpy()
        probs, weights, pred = probs.cpu().numpy(), weights.cpu().numpy(), pred.cpu().numpy()
        out = []
        for b in range(len(probs)):
            by_weight = np.argsort(-weights[b])[:k]
            # Only rows that helped: a plain top k would pad with the least
            # harmful opposing rows when fewer than k helped.
            by_help = [int(r) for r in np.argsort(-infl[b])[:k] if infl[b][r] > 0]
            harmful = int(np.argmin(infl[b]))
            entry = {
                "predicted_class": int(pred[b]),
                "neighbors": [item(r, weights[b][r], "weight") for r in by_weight],
                "helpful": [item(r, infl[b][r], "influence") for r in by_help],
            }
            if infl[b][harmful] < 0:
                entry["most_harmful"] = item(harmful, infl[b][harmful], "influence")
            out.append(entry)
        return np.log(probs + 1e-12), out

    return run


def export_artifact(net: NWNet, train_ds, val_ds, args) -> dict:
    """``--export_artifact DIR`` (JAX ``serve.py:491-537``): the serving
    callable exported to DIR (``utils/aot.py``) at ``--batch_size``, uint8
    pixels in with the imagenet normalization folded in, except CIFAR's
    pre-normalized floats; under ``--mesh`` the mesh program (full mode).
    The metadata names the arch, dataset, classes, precisions and, for
    ``--serve_mode ivf``, the resolved ``ivf_probe``. The ``relation``
    kernel, which has no fused route, is refused."""
    from nwhead_tpu_torch.utils.aot import (
        export_mesh_serving_artifact, export_serving_artifact,
    )

    if net.kernel_type not in KERNEL_NAMES:
        raise ValueError(f"--export_artifact: the {net.kernel_type!r} kernel has no fused "
                         f"serving route to export (the fused kernels: {', '.join(KERNEL_NAMES)})")
    is_cifar = args.dataset in CIFAR_DATASETS
    sample = np.asarray(val_ds.gather(np.arange(1)))
    h, w = sample.shape[1:3]
    spec = np.zeros((args.batch_size, h, w, 3), sample.dtype if is_cifar else np.uint8)
    metadata = {
        "arch": args.arch,
        "dataset": args.dataset,
        "n_classes": int(train_ds.num_classes),
        "featurizer_precision": args.featurizer_precision,
        "head_precision": args.head_precision,
        "normalize": "none (pre-normalized floats)" if is_cifar
        else "imagenet uint8 (folded into the program)",
    }
    stats = None if is_cifar else (T.IMAGENET_MEAN, T.IMAGENET_STD)
    if net.mesh is not None:
        if args.serve_mode != "full":
            raise ValueError("--export_artifact under --mesh exports full mode only, as the "
                             "JAX package does")
        meta = export_mesh_serving_artifact(net, spec, args.export_artifact, normalize=stats,
                                            metadata=metadata)
    else:
        if args.serve_mode != "full":
            # The knob calibrate_ivf resolved in build_server ('auto' never reaches here).
            metadata.update(serve_mode=args.serve_mode, ivf_probe=net.ivf_n_probe)
        fn = serving_fn(net, uint8_normalize=not is_cifar, mode=args.serve_mode)
        meta = export_serving_artifact(fn, spec, args.export_artifact, metadata=metadata)
    report = {"exported": args.export_artifact, **meta}
    print(json.dumps(report))
    return report


def artifact_serve(args) -> dict:
    """``--serve_artifact DIR`` (JAX ``serve.py:540-620``): load the artifact
    (``utils/aot.load_any_serving_artifact``: no model code, no dataset, no
    bank pass) and answer ``--latency_bench`` (random pixels of its input
    shape and dtype, ``--bench_batches`` timed requests after 3 warm ones,
    log-probs back on the host: ``batch_size``, ``p50_ms``, ``p95_ms``,
    ``queries_per_sec``, ``backend`` the device type) and ``--queries``
    (image files through the imagenet eval transform at the artifact's
    height, 224 px for every image-file dataset, uint8 artifacts only; each
    file's ``--topk``)."""
    from nwhead_tpu_torch.utils.aot import load_any_serving_artifact

    if not (args.latency_bench or args.queries):
        raise SystemExit("--serve_artifact: pass --latency_bench and/or --queries")
    t0 = time.perf_counter()
    serve = load_any_serving_artifact(args.serve_artifact)
    load_s = time.perf_counter() - t0
    meta = serve.meta
    B, H, W, _ = meta["input_shape"]
    dtype = np.dtype(meta["input_dtype"])
    out = {"artifact": args.serve_artifact, "meta": meta, "load_seconds": load_s}
    if args.latency_bench:
        rng = np.random.default_rng(0)
        imgs = (rng.integers(0, 256, size=(B, H, W, 3)).astype(dtype) if dtype == np.uint8
                else rng.standard_normal((B, H, W, 3)).astype(dtype))
        for _ in range(3):
            serve(imgs).cpu()
        lat = []
        for _ in range(max(1, args.bench_batches)):
            t0 = time.perf_counter()
            serve(imgs).cpu()  # readback: the request is complete
            lat.append(time.perf_counter() - t0)
        lat_ms = np.asarray(lat) * 1e3
        report = {
            "batch_size": B,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p95_ms": float(np.percentile(lat_ms, 95)),
            "queries_per_sec": B / float(np.median(lat)),
            "backend": meta["device"],
            "device": device_info(torch.device(meta["device"])),
        }
        print(json.dumps(report))
        out["latency"] = report
    if args.queries:
        paths = sorted(glob.glob(args.queries))
        if not paths:
            raise SystemExit(f"no files match {args.queries!r}")
        if dtype != np.uint8:
            raise SystemExit("--queries against a float-input artifact is unsupported (export "
                             "with a uint8 pipeline for image files)")
        qds = ImageFileDataset(paths, np.zeros(len(paths), np.int64), meta.get("n_classes", 0),
                               transform=T.imagenet_eval_transform(H, device_normalize=True),
                               workers=args.workers, decoder=args.decoder)
        results = []
        for start in range(0, len(paths), B):
            chunk = paths[start:start + B]
            imgs = qds.gather(np.arange(start, start + len(chunk)))
            pad = B - len(chunk)
            if pad > 0:
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            lp = serve(imgs).cpu().numpy()[:len(chunk)]
            top = np.argsort(-lp, axis=-1)[:, :args.topk]
            for p, t, row in zip(chunk, top, lp):
                entry = {"file": p, "topk": [{"class": int(c), "prob": round(float(np.exp(row[c])), 4)}
                                             for c in t]}
                results.append(entry)
                print(json.dumps(entry))
        out["queries"] = results
    return out


def _decode_image(data: bytes, transform) -> np.ndarray:
    """One encoded image (JPEG, PNG, ...) through PIL and ``transform``."""
    from io import BytesIO

    from PIL import Image

    with Image.open(BytesIO(data)) as im:
        return transform(np.asarray(im.convert("RGB")))


def build_http_server(net: NWNet, train_ds, val_ds, args) -> NWHttpServer:
    """The HTTP daemon of ``--http PORT`` on ``--http_host``, not yet
    serving (``start()`` serves on a thread, ``serve_forever()`` on this
    one), its ``MicroBatcher`` over the serving callable attached
    (``--batch_size``, ``--microbatch_wait_ms``). On the image-file datasets
    and CIFAR, ``images_b64`` and raw image bodies are decoded by PIL, to
    uint8 224 px pixels (normalized on the device) or CIFAR's floats for a
    prediction, to host-normalized floats for ``/add_support``; the other
    datasets take JSON ``inputs`` of their own item shape only."""
    is_cifar = args.dataset in CIFAR_DATASETS
    image_ds = args.dataset in IMAGE_DATASETS
    decode_query = decode_support = None
    if image_ds or is_cifar:
        t_query = (T.cifar_eval_transform() if is_cifar
                   else T.imagenet_eval_transform(device_normalize=True))
        t_support = T.cifar_eval_transform() if is_cifar else T.imagenet_eval_transform()

        def decode_query(b):
            return _decode_image(b, t_query)

        def decode_support(b):
            return _decode_image(b, t_support)

        input_shape = (224, 224, 3) if image_ds else (32, 32, 3)
    else:
        input_shape = tuple(val_ds.gather(np.arange(1)).shape[1:])
    serve = serving_fn(net, uint8_normalize=image_ds, mode=args.serve_mode)
    server = NWHttpServer(net, None, input_shape=input_shape, decode_query=decode_query,
                          decode_support=decode_support, topk=args.topk,
                          temperature=args.temperature, host=args.http_host, port=args.http)
    server.batcher = MicroBatcher(serve, max_batch=args.batch_size,
                                  max_wait_ms=args.microbatch_wait_ms)
    return server


def http_serve(net: NWNet, train_ds, val_ds, args) -> NWHttpServer:
    """``--http PORT``: print the address and ``/healthz``, then serve until
    interrupted (``build_http_server``)."""
    server = build_http_server(net, train_ds, val_ds, args)
    print(json.dumps({"serving": f"http://{args.http_host}:{server.port}",
                      **server.healthz()}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.httpd.server_close()
        server.batcher.close()
    return server


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NW head serving (PyTorch/CUDA port)")
    p.add_argument("--dataset", required=True,
                   help=f"one of {', '.join(DATASETS)} (the training CLI's datasets)")
    p.add_argument("--data_dir", default="./")
    p.add_argument("--workers", type=int, default=8, help="image-file decode threads")
    p.add_argument("--decoder", default="native_fused", choices=["native", "native_fused", "pil"],
                   help="image-file decoder: the C++ libjpeg pool (native_fused also crops "
                        "and resizes in it) or PIL")
    p.add_argument("--bank_cache", default=None,
                   help="a directory to save the featurized bank to (tagged with what "
                        "computed it), or to restore it from when it holds one with this "
                        "server's tag; another tag is refused")
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint of the port's training CLI (model.NNNN or model.best), "
                        "loaded over the seeded weights before any quantize or fuse")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--kernel_type", default="euclidean")
    p.add_argument("--proj_dim", type=int, default=0,
                   help="a linear projection of the features to this width (0: none)")
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
    p.add_argument("--microbatch_bench", action="store_true",
                   help="one image a request through the MicroBatcher from --concurrency "
                        "clients: qps, request latency, batch occupancy")
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--microbatch_wait_ms", type=float, default=5.0,
                   help="the MicroBatcher's wait before a batch that is not full dispatches "
                        "(--microbatch_bench, --http)")
    p.add_argument("--jpeg_bench", action="store_true",
                   help="JPEG files in, answers out: decode, copy and device stages alone "
                        "and pipelined")
    p.add_argument("--bench_batches", type=int, default=50)
    p.add_argument("--queries", default=None, help="a glob of image files to classify")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="post-hoc calibration temperature of the reported probabilities "
                        "(fit by the eval CLI's --fit_temperature)")
    p.add_argument("--explain", type=int, default=0, metavar="K",
                   help="with --queries: each answer's K heaviest support rows by softmax "
                        "weight and its most helpful and harmful rows by leave-one-out "
                        "influence; these answers come from the exact f32 head over the raw "
                        "bank, so under another --head_precision their probabilities can "
                        "differ slightly from the served ones")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve JSON over HTTP on PORT (0: any free port): /predict through "
                        "the MicroBatcher, /add_support and /remove_support live bank edits, "
                        "/healthz, /stats")
    p.add_argument("--http_host", default="127.0.0.1")
    p.add_argument("--export_artifact", default=None, metavar="DIR",
                   help="build the server, export the serving callable (a torch.export "
                        "program with its weights and bank) to DIR, and exit; serve it later "
                        "with --serve_artifact DIR (no model code, dataset or bank pass "
                        "needed at load)")
    p.add_argument("--serve_artifact", default=None, metavar="DIR",
                   help="serve from an artifact written by --export_artifact instead of "
                        "building the model; supports --latency_bench and --queries")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.serve_artifact:
        return artifact_serve(args)
    if not (args.latency_bench or args.microbatch_bench or args.jpeg_bench or args.queries
            or args.http is not None or args.export_artifact):
        raise SystemExit("pass --latency_bench, --microbatch_bench, --jpeg_bench, --queries, "
                         "--http and/or --export_artifact")
    featurizer_options(args)  # refuse before the datasets are drawn
    train_ds, val_ds = build_datasets(args)
    net = build_server(args, train_ds, val_ds=val_ds)
    if args.export_artifact:
        return export_artifact(net, train_ds, val_ds, args)
    if args.http is not None:
        return http_serve(net, train_ds, val_ds, args)
    out = {}
    if args.latency_bench:
        out["latency"] = latency_bench(net, val_ds, args)
    if args.microbatch_bench:
        out["microbatch"] = microbatch_bench(net, val_ds, args)
    if args.jpeg_bench:
        out["jpeg"] = jpeg_bench(net, train_ds, args)
    if args.queries:
        # With --jpeg_bench the same files were the bench's input; they are
        # still classified.
        out["queries"] = answer_queries(net, train_ds, args)
    return out


if __name__ == "__main__":
    main()
