"""The evaluation CLI of the port: ``python -m nwhead_tpu_torch.eval``.

Port of the root ``eval.py`` of the JAX package: load a checkpoint of the
training CLI (``--ckpt``, a ``model.NNNN`` file of ``train/checkpoint.py``),
precompute the support bank, evaluate any of the modes ``random``,
``full``, ``cluster``, ``ensemble``, ``knn``, ``hnsw`` and ``ivf``
(``--n_neighbors`` a query in knn and hnsw, whose support is the union of
the batch's neighbours, the tail batch's zero-image padding rows
included, as in the JAX CLI), print each mode's accuracy, NLL and ECE,
and as the last line the results as JSON. ``--fit_temperature`` fits a
temperature on a seeded random half of each mode's predictions and reports
the other half's NLL and ECE raw and calibrated; ``--influence_queries N``
prints the five most helpful full-bank items of each of the first N
validation images by leave-one-out influence. ``--bank_cache DIR`` saves
the featurized bank there after ``precompute`` (``FeatureBankCache``), or,
when DIR holds one, restores it (``NWNet.restore_bank``) instead of
featurizing the support set; as in the JAX CLI the cache carries no tag,
so it is the caller's to keep it with the weights that wrote it, and it is
refused with the fused or quantized featurizers. The datasets are the
training CLI's (``--data_dir``, ``--workers``, ``--decoder``). Without
``--ckpt`` the weights are random, from ``--seed``. For example::

    python -m nwhead_tpu_torch.eval --dataset digits --arch resnet10 \\
        --ckpt <run_dir>/checkpoints/model.0008 --modes random full cluster \\
        --fit_temperature --influence_queries 8

The featurizer and head flags are the serve CLI's (``--head_precision``,
``--fused_inference`` and ``--featurizer_precision bf16_fused|int8`` on
ViTs, ``--bf16``, ``--pretrained_path``, ``--mesh``); ``--arch resnet18``
and ``densenet121`` build their CIFAR models on CIFAR, as the JAX CLI
does. Flag values the port does not run yet raise
``NotImplementedError`` naming their ROADMAP.md item. ``--device``
defaults to ``cuda``; with no CUDA device that is an error, and the CPU
must be asked for (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from nwhead_tpu_torch.data.datasets import draw_init_sample
from nwhead_tpu_torch.data.embedding_cache import FeatureBankCache
from nwhead_tpu_torch.data.pipeline import prefetch_to_device
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import metrics as M
from nwhead_tpu_torch.ops.calibrate import apply_temperature, fit_temperature
from nwhead_tpu_torch.serve import build_mesh, featurizer_options
from nwhead_tpu_torch.train import build_datasets
from nwhead_tpu_torch.train.checkpoint import load_checkpoint
from nwhead_tpu_torch.train.config import cifar_name
from nwhead_tpu_torch.train.trainer import _host_eval_batches

MODES = ("random", "full", "cluster", "ensemble", "knn", "hnsw", "ivf")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NW head evaluation (PyTorch/CUDA port)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="./")
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a checkpoint of the training CLI (model.NNNN or model.best)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--modes", nargs="+", default=["random", "full", "cluster"], choices=MODES)
    p.add_argument("--kernel_type", type=str, default="euclidean")
    p.add_argument("--proj_dim", type=int, default=0)
    p.add_argument("--n_shot_full", type=int, default=100)
    p.add_argument("--n_shot_random", type=int, default=1)
    p.add_argument("--n_shot_cluster", type=int, default=1)
    p.add_argument("--n_neighbors", type=int, default=10,
                   help="modes knn and hnsw: neighbours a query; the head's support is the "
                        "union of the batch's neighbours")
    p.add_argument("--ivf_group_b", type=int, default=None,
                   help="mode ivf: route-sort the batch and give each block of this many "
                        "queries its own tile union (default: one union per batch)")
    p.add_argument("--ivf_n_probe", type=lambda v: v if v == "auto" else int(v), default=32,
                   help="mode ivf: bank tiles routed per query (at least the tile count "
                        "is exact full mode); 'auto' calibrates on the first batch")
    p.add_argument("--num_val_steps", type=int, default=10**9)
    p.add_argument("--bank_cache", type=str, default=None,
                   help="a directory to save the featurized bank to, or to restore it from "
                        "when it holds one")
    p.add_argument("--influence_queries", type=int, default=0,
                   help="print support-influence rankings for the first N queries")
    p.add_argument("--fit_temperature", action="store_true",
                   help="fit a temperature per mode on a seeded random half of the val "
                        "predictions and report the other half's nll/ece raw vs calibrated")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="compute the featurizer in bf16")
    p.add_argument("--head_precision", type=str, default="f32",
                   choices=["f32", "bf16", "int8", "int4"],
                   help="the full mode's prepared bank: f32/bf16 (K2), int8 (K4), int4 (K5)")
    p.add_argument("--featurizer_precision", type=str, default="f32",
                   choices=["f32", "int8", "bf16_fused"],
                   help="int8: a ViT's int8 post-training-quantized graph (K10/K11 int8); "
                        "bf16_fused: a ViT's bf16 fused-serving graph (K10/K11)")
    p.add_argument("--calib_images", type=int, default=256,
                   help="training images that calibrate --featurizer_precision int8")
    p.add_argument("--fused_inference", action="store_true",
                   help="a ViT's attention and MLP on the fused kernels K7 and K9")
    p.add_argument("--workers", type=int, default=8, help="image-file decode threads")
    p.add_argument("--decoder", type=str, default="native",
                   choices=["native", "native_fused", "pil"])
    p.add_argument("--pretrained_path", type=str, default=None,
                   help="a local torchvision- or DINOv2-format checkpoint merged into the "
                        "backbone before --ckpt")
    p.add_argument("--mesh", type=str, default=None,
                   help="'N_DATA,N_SUPPORT[,N_MODEL]': a bank sharded over N_SUPPORT devices "
                        "for the full and ivf modes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default) fails without a GPU; the CPU must be asked for")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="the JAX CLI's backend flag; 'cpu' is --device cpu")
    args = p.parse_args(argv)
    if args.platform == "cpu":
        args.device = "cpu"
    return args


def check_ported(args) -> None:
    """Refuse what the CLI does not run: the featurizer flags are checked
    by ``serve.featurizer_options``; ``--bank_cache`` with a fused or
    quantized featurizer exits as the JAX CLI does (cached float features
    would mix with the other featurizer's query features)."""
    featurizer_options(args)
    if args.bank_cache and args.featurizer_precision in ("int8", "bf16_fused"):
        raise SystemExit(f"--bank_cache cannot be combined with --featurizer_precision "
                         f"{args.featurizer_precision}: cached float bank features would mix "
                         "with its query features; precompute fresh")


def build_net(args, train_ds) -> NWNet:
    """The network on ``--device``: the backbone (``cifar_name(--arch,
    --dataset)``, random weights from ``--seed``, ``--pretrained_path``'s
    merged in, then ``--ckpt``'s), the featurizer fused or quantized as
    asked, and the support bank precomputed (full, cluster; prepared or
    sharded for the fused head; the HNSW graph at the first hnsw batch), or
    restored from ``--bank_cache`` (``install_bank``)."""
    device = torch.device(args.device)
    featurizer = load_model(cifar_name(args.arch, args.dataset), device=device,
                            generator=torch.Generator().manual_seed(args.seed),
                            **featurizer_options(args))
    net = NWNet(
        featurizer, train_ds.num_classes, support_dataset=train_ds, device=device,
        feat_dim=featurizer.feat_dim, proj_dim=args.proj_dim, kernel_type=args.kernel_type,
        n_shot_full=args.n_shot_full, n_shot_random=args.n_shot_random,
        n_shot_cluster=args.n_shot_cluster, n_neighbors=args.n_neighbors,
        head_precision=args.head_precision,
        ivf_n_probe=args.ivf_n_probe, ivf_group_b=args.ivf_group_b, seed=args.seed,
        mesh=build_mesh(args, device),
    )
    draw_init_sample(train_ds, args.batch_size)
    if args.ckpt:
        net.model.load_state_dict(load_checkpoint(args.ckpt)["model"])
        print(f"Loaded checkpoint {args.ckpt}")
    if args.featurizer_precision == "int8":
        n_cal = min(args.calib_images, len(train_ds))
        net.quantize_featurizer(train_ds.gather(np.arange(n_cal)))
        print(f"Quantized featurizer (int8 PTQ, {n_cal} calibration images)")
    elif args.featurizer_precision == "bf16_fused":
        net.fuse_featurizer()
        print("Fused featurizer (bf16 serving graph, LN/residual folded)")
    install_bank(net, args.bank_cache)
    return net


def install_bank(net: NWNet, cache_dir=None) -> None:
    """The support bank: ``restore_bank`` from ``cache_dir`` when it holds
    a cache, else ``precompute`` (then saved there, features and labels,
    when ``cache_dir`` is given). ``net.bank_seconds`` keeps the host
    seconds either took, the device synchronized."""
    cache = FeatureBankCache(cache_dir) if cache_dir else None
    t0 = time.perf_counter()
    if cache is not None and cache.exists():
        emb, lbl, meta = cache.load()
        net.restore_bank(emb, lbl, meta)
        what = f"Loaded cached bank from {cache_dir} ({len(lbl)} items)"
    else:
        net.precompute()
        what = "Precomputed the bank"
        if cache is not None:
            cache.save(net.full_feat.cpu().numpy(), net.full_y.cpu().numpy())
            what = f"Saved bank to {cache_dir}"
    if net.device.type == "cuda":
        torch.cuda.synchronize(net.device)
    net.bank_seconds = time.perf_counter() - t0
    print(f"{what}, {net.bank_seconds:.3f}s")


def evaluate_mode(net: NWNet, val_ds, mode: str, batch_size: int, num_steps: int):
    """One pass over the validation set in ``mode``, the tail batch padded
    with zero images: ``(result, log_probs (n, C) f32, labels (n,))``,
    ``result`` with ``acc``, ``nll``, ``ece`` (x100) and ``n``."""
    lps_all, gts = [], []
    correct = total = 0
    loss_sum = 0.0
    batches = prefetch_to_device(_host_eval_batches(val_ds, batch_size, num_steps),
                                 net.device, size=2)
    for img, label in batches:
        real = label.shape[0]
        out = net.predict(img, mode)[:real]
        loss_sum += float(M.nll_loss(out, label)) * real
        correct += int((torch.argmax(out, -1) == label).sum())
        total += real
        lps_all.append(out.to(torch.float32).cpu().numpy())
        gts.append(label.cpu().numpy())
    lps, ys = np.concatenate(lps_all), np.concatenate(gts)
    ece = float(M.ece(np.exp(lps), ys)) * 100
    result = {"acc": 100.0 * correct / total, "nll": loss_sum / total, "ece": ece, "n": total}
    print(f"[{mode}] acc={result['acc']:.3f}% nll={result['nll']:.4f} ece={ece:.3f}")
    return result, lps, ys


def calibrate(result: dict, lps: np.ndarray, ys: np.ndarray, mode: str, seed: int,
              device) -> None:
    """Post-hoc temperature scaling: ``T`` fitted on a seeded random half
    of the predictions (a permutation: a class-sorted val set would put
    other classes in each half), the other half's NLL and ECE raw and
    calibrated added to ``result``."""
    perm = np.random.default_rng(seed).permutation(len(ys))
    lps, ys = lps[perm], ys[perm]
    h = len(ys) // 2
    fit_lp, fit_y = torch.from_numpy(lps[:h]).to(device), torch.from_numpy(ys[:h]).to(device)
    T = float(fit_temperature(fit_lp, fit_y))
    hold, yh = torch.from_numpy(lps[h:]).to(device), torch.from_numpy(ys[h:]).to(device)
    cal = apply_temperature(hold, T)
    result.update({
        "temperature": T,
        "nll_holdout_raw": float(M.nll_loss(hold, yh)),
        "nll_holdout_cal": float(M.nll_loss(cal, yh)),
        "ece_holdout_raw": float(M.ece(torch.exp(hold), yh)) * 100,
        "ece_holdout_cal": float(M.ece(torch.exp(cal), yh)) * 100,
    })
    print(f"[{mode}] T={T:.3f}  holdout nll "
          f"{result['nll_holdout_raw']:.4f}->{result['nll_holdout_cal']:.4f}  "
          f"ece {result['ece_holdout_raw']:.3f}->{result['ece_holdout_cal']:.3f}")


def influence_rankings(net: NWNet, val_ds, n_queries: int) -> np.ndarray:
    """Print the five most helpful full-bank items of each of the first
    ``n_queries`` validation images; returns the influences ``(n, S)``."""
    infl = net.support_influence(val_ds.gather(np.arange(n_queries)),
                                 val_ds.targets[:n_queries], mode="full")
    order = np.argsort(-infl, axis=-1)
    print("Top-5 most helpful support items per query (index: influence):")
    for i in range(n_queries):
        tops = ", ".join(f"{j}:{infl[i, j]:+.4f}" for j in order[i, :5])
        print(f"  query {i} (y={val_ds.targets[i]}): {tops}")
    return infl


def main(argv=None, datasets=None) -> dict:
    """Parse, build the datasets (unless ``datasets=(train, val)`` gives
    them) and the network, evaluate every mode, and print the results."""
    args = parse_args(argv)
    check_ported(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")
    train_ds, val_ds = datasets if datasets is not None else build_datasets(args)
    net = build_net(args, train_ds)
    results = {}
    for mode in args.modes:
        result, lps, ys = evaluate_mode(net, val_ds, mode, args.batch_size, args.num_val_steps)
        results[mode] = result
        if args.fit_temperature and result["n"] >= 4:
            calibrate(result, lps, ys, mode, args.seed, net.device)
    if args.influence_queries > 0:
        influence_rankings(net, val_ds, args.influence_queries)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
