"""The training CLI of the port: ``python -m nwhead_tpu_torch.train``.

Port of the root ``train.py`` of the JAX package: build the datasets and
the network, then the eval-before-train epoch loop, with periodic
checkpoints and ``--resume``. ``--train_method nwhead`` trains the NW head
on episodes (``NWTrainer``), ``fchead`` the FC baseline on minibatches
(``FCNet``, ``FCTrainer``; each epoch evaluates it once). The datasets are
the JAX CLI's, with its transforms and splits: the in-memory
``synthetic``, ``synthetic_cub`` and ``digits``, the image trees ``bird``
(CUB-200-2011), ``dog``, ``flower`` and ``aircraft`` under ``--data_dir``,
decoded by ``--decoder`` on ``--workers`` threads, and ``cifar10`` /
``cifar100`` from ``<data_dir>/<name>/{train,test}_{images,labels}.npy``::

    python -m nwhead_tpu_torch.train --dataset cifar100 --data_dir data \
        --arch resnet18 --train_method fchead --batch_size 128 --lr 0.1

Weights are random, from ``--seed``, or ``--pretrained_path``'s (a local
torchvision- or DINOv2-format file, merged at build time; ``--resume``
overrides them). Each epoch evaluates in the random,
full and cluster modes (one centroid a class, as the JAX CLI). The
CUB-scale episode that reaches the fused kernels K1/K3 (every one of the
200 classes, 6 shots: 1,200 support rows)::

    python -m nwhead_tpu_torch.train --dataset synthetic_cub --arch resnet18 \\
        --batch_size 8 --n_shot 6 --lr 1e-2

``--arch`` takes the JAX CLI's archs (``config.featurizer_name``):
``resnet10``, ``resnet18``, ``resnet34``, ``resnet50``, ``densenet121``
(``CIFAR_ResNet18`` and ``CIFAR_DenseNet121`` on CIFAR) and the ViTs; a CNN
computes in bf16 with ``--bf16`` (flax's mixed precision). ResNet-50 on the
CUB-scale data, from a torchvision file::

    python -m nwhead_tpu_torch.train --dataset synthetic_cub --arch resnet50 \\
        --pretrained_path resnet50.pth --batch_size 8 --n_shot 2 --bf16

``--arch vit_s14`` (``dinov2_vits14``, ``vit_s16``) trains the ViT on its
plain ``xla`` impls, as the JAX CLI does, optionally in bf16 (``--bf16``).
The library path ``setup(argv, featurizer_kwargs={"attn_impl": "fused",
"mlp_impl": "fused"})`` trains it on the kernels K7/K8 and K9 forward and
backward, as JAX's ``load_model(name, attn_impl="fused", mlp_impl="fused")``
does.

``--mesh N_DATA,N_SUPPORT[,N_MODEL]`` trains data-parallel over the first
n CUDA devices (``serve.build_mesh``; n copies of the CPU with ``--device
cpu``): each step the query batch splits over the data axis, BatchNorm
syncs over it, and full-mode eval runs over the support-sharded bank
(``NWTrainer(mesh=)``; ``--train_method nwhead`` only, as in JAX)::

    python -m nwhead_tpu_torch.train --device cpu --dataset synthetic \
        --arch resnet10 --batch_size 4 --mesh 2,2 --num_epochs 1

``--use_wandb`` starts a W&B run after the set-up (``initialize_wandb``; an
``ImportError`` naming ``--no_use_wandb`` where wandb is not installed) and
logs the train and validation metrics every epoch, as the JAX CLI does.

``--device`` defaults to ``cuda``; with no CUDA device that is an error, and
the CPU must be asked for (``--device cpu``).
"""

from __future__ import annotations

import numpy as np
import torch

import os

from nwhead_tpu_torch.data import transforms as T
from nwhead_tpu_torch.data.datasets import (
    ArrayDataset, Cub200Dataset, FGVCAircraftDataset, Flowers102Dataset, StanfordDogDataset,
    make_digits_dataset, make_synthetic_dataset,
)
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.nw.fc import FCNet
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.train.checkpoint import (
    latest_checkpoint, load_checkpoint, load_sampler_state, save_checkpoint,
    save_sampler_state,
)
from nwhead_tpu_torch.train.config import (
    CIFAR_DATASETS, Parser, featurizer_name, initialize_wandb,
)
from nwhead_tpu_torch.train.trainer import FCTrainer, NWTrainer, multistep_lr


def build_datasets(args):
    """``(train, val)``, as the JAX CLI builds them: ``synthetic`` (64/32
    images of 32 px, 4 classes), ``synthetic_cub`` (the CUB-200 recipe's
    scale: 5994/1000 images of 224 px, 200 classes, about 3.6 GB of f32),
    ``digits`` (scikit-learn's handwritten digits at 32 px); from
    ``args.data_dir`` with the imagenet transforms (train seeded by
    ``args.seed``), ``args.workers`` and ``args.decoder``: ``bird``
    (CUB-200-2011's split), ``dog``, ``flower`` (Flowers-102 train /
    test) and ``aircraft`` (FGVC-Aircraft trainval / test); with the CIFAR
    transforms, ``cifar10`` and ``cifar100`` (``_load_cifar``)."""
    if args.dataset in CIFAR_DATASETS:
        return _load_cifar(args.data_dir, args.dataset, T.cifar_train_transform(seed=args.seed),
                           T.cifar_eval_transform())
    t_train, t_test = T.imagenet_train_transform(seed=args.seed), T.imagenet_eval_transform()
    kw = dict(workers=args.workers, decoder=args.decoder)
    if args.dataset == "bird":
        return (Cub200Dataset(args.data_dir, True, t_train, **kw),
                Cub200Dataset(args.data_dir, False, t_test, **kw))
    if args.dataset == "dog":
        return (StanfordDogDataset(args.data_dir, True, t_train, **kw),
                StanfordDogDataset(args.data_dir, False, t_test, **kw))
    if args.dataset == "flower":
        return (Flowers102Dataset(args.data_dir, "train", t_train, **kw),
                Flowers102Dataset(args.data_dir, "test", t_test, **kw))
    if args.dataset == "aircraft":
        return (FGVCAircraftDataset(args.data_dir, "trainval", t_train, **kw),
                FGVCAircraftDataset(args.data_dir, "test", t_test, **kw))
    if args.dataset == "synthetic":
        return (make_synthetic_dataset(n=64, n_classes=4, size=32, seed=args.seed),
                make_synthetic_dataset(n=32, n_classes=4, size=32, seed=args.seed + 1))
    if args.dataset == "synthetic_cub":
        return (make_synthetic_dataset(n=5994, n_classes=200, size=224, seed=args.seed,
                                       class_patterns=0.25),
                make_synthetic_dataset(n=1000, n_classes=200, size=224, seed=args.seed + 1,
                                       class_patterns=0.25))
    if args.dataset == "digits":
        return make_digits_dataset(True), make_digits_dataset(False)
    raise NotImplementedError(f"dataset {args.dataset!r}")


def _load_cifar(data_dir: str, name: str, t_train, t_test):
    """CIFAR from ``<data_dir>/<name>/{train,test}_{images,labels}.npy``
    ((N, 32, 32, 3) uint8 images, integer labels), 10 or 100 classes."""
    base = os.path.join(data_dir, name)

    def load(split: str):
        return (np.load(os.path.join(base, f"{split}_images.npy")),
                np.load(os.path.join(base, f"{split}_labels.npy")))

    n_classes = 10 if name == "cifar10" else 100
    return (ArrayDataset(*load("train"), n_classes, transform=t_train),
            ArrayDataset(*load("test"), n_classes, transform=t_test))


def build_network(args, train_dataset, **featurizer_kwargs):
    """The backbone ``featurizer_name(--arch, --dataset)``, with random
    weights from ``--seed`` and ``--pretrained_path`` merged in, and the NW
    network (``--train_method nwhead``, over ``--mesh``'s mesh when it is
    set) or ``FCNet`` (``fchead``, its classifier drawn from ``--seed``) on
    ``--device``.
    ``featurizer_kwargs`` go to ``load_model`` (a
    ViT's ``attn_impl='fused', mlp_impl='fused'`` trains on K7/K8 and the
    K9 forward and backward; a DenseNet's ``memory_efficient=True``
    checkpoints its dense layers); ``--bf16`` adds
    ``dtype=torch.bfloat16``."""
    from nwhead_tpu_torch.serve import build_mesh  # serve imports this module

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")
    if args.mesh and args.train_method == "fchead":
        raise NotImplementedError("--mesh supports --train_method nwhead only")
    mesh = build_mesh(args, device)
    if args.bf16:
        featurizer_kwargs = {"dtype": torch.bfloat16, **featurizer_kwargs}
    featurizer = load_model(featurizer_name(args.arch, args.dataset), device=device,
                            generator=torch.Generator().manual_seed(args.seed),
                            pretrained=args.pretrained_path or False, **featurizer_kwargs)
    if args.train_method == "fchead":
        return FCNet(featurizer, train_dataset.num_classes,
                     generator=torch.Generator().manual_seed(args.seed)).to(device)
    if args.train_method != "nwhead":
        raise NotImplementedError(f"--train_method {args.train_method}")
    return NWNet(
        featurizer, train_dataset.num_classes, support_dataset=train_dataset, device=device,
        feat_dim=featurizer.feat_dim, proj_dim=args.proj_dim, kernel_type=args.kernel_type,
        train_type=args.train_type, n_shot=args.n_shot, n_way=args.n_way,
        debug_mode=args.debug_mode, head_precision=args.head_precision, seed=args.seed,
        mesh=mesh,
    )


def setup(argv=None, datasets=None, featurizer_kwargs=None):
    """Parse the flags, build datasets (unless ``datasets=(train, val)``
    gives them), network (``featurizer_kwargs`` go to ``load_model``) and
    trainer (``NWTrainer`` or ``FCTrainer``; an ``NWTrainer`` over the
    network's mesh), resume from the newest checkpoint with
    ``--resume``, and start W&B with ``--use_wandb``: ``(args, trainer,
    start_epoch)``. An FC
    run resumes as the JAX CLI's does: weights, optimizer and step, not the
    trainer's generator, so its next epoch draws a fresh generator's
    permutation."""
    args = Parser().parse(argv)
    if args.seed > 0:
        np.random.seed(args.seed)
    train_ds, val_ds = datasets if datasets is not None else build_datasets(args)
    network = build_network(args, train_ds, **(featurizer_kwargs or {}))
    common = dict(lr=args.lr, batch_size=args.batch_size,
                  milestones=args.scheduler_milestones, gamma=args.scheduler_gamma,
                  weight_decay=args.weight_decay, freeze_featurizer=args.freeze_featurizer,
                  seed=args.seed)
    if args.train_method == "fchead":
        trainer = FCTrainer(network, train_ds, val_ds, **common)
    else:
        trainer = NWTrainer(network, train_ds, val_ds, mesh=network.mesh, **common)
    start_epoch = 1
    path = latest_checkpoint(args.ckpt_dir) if args.resume else None
    if path:
        ckpt = load_checkpoint(path)
        trainer.load_state_dict(ckpt)
        start_epoch = int(ckpt["epoch"]) + 1
        sampler = load_sampler_state(path) if args.train_method == "nwhead" else None
        if sampler is not None:
            network.support_train.set_rng_state(sampler["support"])
            trainer.rng.bit_generator.state = sampler["trainer"]
            print("Restored sampler RNG state")
        print(f"Resumed from {path} at epoch {start_epoch}")
    if args.use_wandb:
        initialize_wandb(args)
    return args, trainer, start_epoch


def run_epochs(args, trainer, start_epoch: int = 1):
    """The epoch loop: log the schedule's steps an epoch
    (``steps_per_epoch=N``), then each epoch evaluate (every mode of an NW
    net, the FC net once), train an epoch, checkpoint every ``--log_interval`` epochs (an NW run
    with the sampler sidecar), print metrics (and log them to W&B with
    ``--use_wandb``)."""
    best_acc1 = 0.0
    nw = isinstance(trainer, NWTrainer)
    print(f"steps_per_epoch={trainer.steps_per_epoch}")  # the lr schedule's epoch
    for epoch in range(start_epoch, args.num_epochs + 1):
        print("Epoch:", epoch)
        print(f"lr={trainer.lr_schedule(trainer.step):.6g}")
        if nw:
            acc1 = trainer.eval_all_modes(num_steps=args.num_val_steps_per_epoch)
        else:
            acc1 = trainer.eval_epoch(num_steps=args.num_val_steps_per_epoch)
        print("Training...")
        trainer.train_epoch(num_steps=args.num_steps_per_epoch)
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        if epoch % args.log_interval == 0:
            path = save_checkpoint(epoch, trainer.state_dict(), args.ckpt_dir, is_best=is_best)
            if nw:
                save_sampler_state(path, trainer.net.support_train.rng_state(),
                                   trainer.rng.bit_generator.state)
        print("Train loss={:.6f}, train acc={:.6f}".format(
            trainer.metrics["loss:train"].result(), trainer.metrics["acc:train"].result()))
        for k, m in sorted(trainer.val_metrics.items()):
            print(f"{k}={m.result():.6f}")
        if args.use_wandb:
            import wandb

            wandb.log({k: v.result() for k, v in trainer.metrics.items()})
            wandb.log({k: v.result() for k, v in trainer.val_metrics.items()})
        trainer.reset_metrics()
    return trainer


def main(argv=None):
    return run_epochs(*setup(argv))


__all__ = [
    "FCTrainer", "NWTrainer", "Parser", "build_datasets", "build_network", "featurizer_name",
    "initialize_wandb", "latest_checkpoint",
    "load_checkpoint", "main", "multistep_lr", "run_epochs", "save_checkpoint", "setup",
]
