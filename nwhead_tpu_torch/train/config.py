"""The training CLI's flags: the JAX package's surface
(``nwhead_tpu/train/config.py``), ``--x/--no_x`` boolean pairs, ``key=value``
kwargs, the hyperparameter-encoding run directory and its ``args.txt``,
plus ``--device``. ``parse`` refuses every ``--arch`` outside the JAX
CLI's map (``featurizer_name``) before anything is built.
``initialize_wandb`` is the JAX package's optional W&B start
(``--use_wandb``).
"""

from __future__ import annotations

import argparse
import json
import os
from pprint import pprint

CIFAR_DATASETS = ("cifar10", "cifar100")
# In memory, then read from --data_dir: image trees (CUB-200, Stanford Dogs,
# Flowers-102, FGVC-Aircraft) and CIFAR's .npy arrays.
DATASETS = ("synthetic", "synthetic_cub", "digits", "bird", "dog", "flower",
            "aircraft") + CIFAR_DATASETS
# The archs the JAX training CLI builds as they are named (train.py:121-129);
# resnet18 and densenet121 are mapped to their CIFAR models on CIFAR.
TRAIN_ARCHS = ("resnet18", "densenet121", "resnet50", "resnet34", "resnet10", "dinov2_vits14",
               "vit_s14", "vit_s16")


def cifar_name(arch: str, dataset: str) -> str:
    """``resnet18`` -> ``CIFAR_ResNet18`` and ``densenet121`` ->
    ``CIFAR_DenseNet121`` on CIFAR, any other name as it is: the JAX eval
    CLI's map (``eval.py:106-108``)."""
    if dataset in CIFAR_DATASETS:
        return {"resnet18": "CIFAR_ResNet18", "densenet121": "CIFAR_DenseNet121"}.get(arch, arch)
    return arch


def featurizer_name(arch: str, dataset: str) -> str:
    """The registry name the training CLI builds for ``--arch`` on
    ``--dataset``, as the JAX CLI maps it (``train.py:121-129``):
    ``resnet18`` -> ``CIFAR_ResNet18`` and ``densenet121`` ->
    ``CIFAR_DenseNet121`` on CIFAR; any other arch outside ``TRAIN_ARCHS``
    raises ``NotImplementedError``."""
    if arch not in TRAIN_ARCHS:
        raise NotImplementedError(f"--arch {arch}: the training CLI builds {TRAIN_ARCHS}, "
                                  "as the JAX CLI does")
    return cifar_name(arch, dataset)


def parse_bool(v: str) -> bool:
    if v.lower() == "true":
        return True
    if v.lower() == "false":
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


class ParseKwargs(argparse.Action):
    """``key1=value1 key2=value2`` -> dict with int/float/bool coercion."""

    def __call__(self, parser, namespace, values, option_string=None):
        out = {}
        for value in values:
            key, raw = value.split("=", 1)
            if raw.replace("-", "").isnumeric():
                out[key] = int(raw)
            elif raw.replace("-", "").replace(".", "").isnumeric():
                out[key] = float(raw)
            elif raw in ("True", "true"):
                out[key] = True
            elif raw in ("False", "false"):
                out[key] = False
            else:
                out[key] = raw
        setattr(namespace, self.dest, out)


class Parser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(
            description="NW head training (PyTorch/CUDA port). Each epoch evaluates "
                        "first, in the random, full and cluster modes, then trains.")
        # I/O
        self.add_argument("--models_dir", default="./", type=str)
        self.add_argument("--data_dir", default="./", type=str)
        self.add_argument("--log_interval", type=int, default=25)
        self.add_argument("--workers", type=int, default=8,
                          help="image-file decode threads")
        self.add_argument("--decoder", type=str, default="native",
                          choices=["native", "native_fused", "pil"],
                          help="image-file decoder: the C++ libjpeg pool (native; "
                               "native_fused also crops and resizes in it) or PIL")
        self.add_bool_arg("debug_mode", False)

        # ML
        self.add_argument("--dataset", type=str, required=True,
                          help=f"one of {', '.join(DATASETS)}; bird, dog, flower and "
                               "aircraft read their image trees under --data_dir, cifar10 "
                               "and cifar100 <data_dir>/<name>/{train,test}_{images,labels}"
                               ".npy")
        self.add_argument("--lr", type=float, default=1e-3)
        self.add_argument("--batch_size", type=int, default=1)
        self.add_argument("--num_steps_per_epoch", type=int, default=10000000)
        self.add_argument("--num_val_steps_per_epoch", type=int, default=10000000)
        self.add_argument("--num_epochs", type=int, default=200)
        self.add_argument("--scheduler_milestones", nargs="+", type=int, default=(100, 150))
        self.add_argument("--scheduler_gamma", type=float, default=0.1)
        self.add_argument("--seed", type=int, default=0)
        self.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                          help="'cuda' (default) fails without a GPU; the CPU must be "
                               "asked for")
        self.add_argument("--platform", default="default", choices=["default", "cpu"],
                          help="the JAX CLI's backend flag; 'cpu' is --device cpu")
        self.add_argument("--weight_decay", type=float, default=1e-4)
        self.add_argument("--arch", type=str, default="resnet18")
        self.add_argument("--pretrained_path", type=str, default=None,
                          help="a local torchvision- or DINOv2-format checkpoint (.pth/.pt/"
                               ".npz) merged into the backbone at build time")
        self.add_argument("--mesh", type=str, default=None,
                          help="N_DATA,N_SUPPORT[,N_MODEL]: data-parallel training over the "
                               "first n CUDA devices (n copies of the CPU with --device cpu)")
        self.add_argument("--train_method", default="nwhead", help="nwhead or fchead")
        self.add_bool_arg("freeze_featurizer", False)
        self.add_bool_arg("resume", False)
        self.add_bool_arg("bf16", False)

        # NW head
        self.add_argument("--kernel_type", type=str, default="euclidean")
        self.add_argument("--proj_dim", type=int, default=0)
        self.add_argument("--n_shot", type=int, default=1)
        self.add_argument("--n_way", type=int, default=None)
        self.add_argument("--train_type", type=str, default="random",
                          choices=["random", "irm"])
        self.add_argument("--head_precision", type=str, default="f32",
                          choices=["f32", "bf16", "int8", "int4"],
                          help="int8/int4 quantize the full-mode eval's prepared bank (K4/K5); "
                               "training runs the head at f32 then, as the JAX CLI does")

        # Weights & Biases
        self.add_bool_arg("use_wandb", False)
        self.add_argument("--wandb_api_key_path", type=str)
        self.add_argument("--wandb_kwargs", nargs="*", action=ParseKwargs, default={})

    def add_bool_arg(self, name: str, default: bool = True) -> None:
        group = self.add_mutually_exclusive_group(required=False)
        group.add_argument("--" + name, dest=name, action="store_true")
        group.add_argument("--no_" + name, dest=name, action="store_false")
        self.set_defaults(**{name: default})

    def parse(self, argv=None):
        """Parse, refuse an ``--arch`` the training CLI does not build, make
        the run directory and write ``args.txt``."""
        args = self.parse_args(argv)
        if args.platform == "cpu":
            args.device = "cpu"
        featurizer_name(args.arch, args.dataset)
        args.run_dir = os.path.join(
            args.models_dir,
            "method{method}_dataset{dataset}_arch{arch}_lr{lr}_bs{bs}_projdim{proj}"
            "_nshot{nshot}_nway{nway}_wd{wd}_seed{seed}".format(
                method=args.train_method, dataset=args.dataset, arch=args.arch, lr=args.lr,
                bs=args.batch_size, proj=args.proj_dim, nshot=args.n_shot, nway=args.n_way,
                wd=args.weight_decay, seed=args.seed,
            ),
        )
        args.ckpt_dir = os.path.join(args.run_dir, "checkpoints")
        os.makedirs(args.ckpt_dir, exist_ok=True)
        print("Arguments:")
        pprint(vars(args))
        with open(os.path.join(args.run_dir, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=4)
        return args


def initialize_wandb(config) -> None:
    """Optional W&B start (the reference's ``util/utils.py:70-76``, JAX
    ``train/config.py:142-153``): the import is gated, since wandb may be
    absent; the API key is read from ``wandb_api_key_path``, then
    ``wandb.init(**wandb_kwargs)`` and the run's config."""
    try:
        import wandb
    except ImportError as e:
        raise ImportError("wandb is not installed; run with --no_use_wandb") from e
    if config.wandb_api_key_path is not None:
        with open(config.wandb_api_key_path) as f:
            os.environ["WANDB_API_KEY"] = f.read().strip()
    wandb.init(**config.wandb_kwargs)
    wandb.config.update(config)
