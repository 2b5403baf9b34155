"""The training CLI's flags: the JAX package's surface
(``nwhead_tpu/train/config.py``), ``--x/--no_x`` boolean pairs, ``key=value``
kwargs, the hyperparameter-encoding run directory and its ``args.txt``,
plus ``--device``. ``check_ported`` refuses, naming the ROADMAP item, every
flag value this port does not run yet, and the ViTs the JAX CLI does not
train (``vit_b14``, ``vit_l14``).
"""

from __future__ import annotations

import argparse
import json
import os
from pprint import pprint

from nwhead_tpu_torch.models import VIT_NAMES

# Datasets read from image files; they need a download and the image
# transforms, neither of which the port has yet.
FILE_DATASETS = ("bird", "dog", "flower", "aircraft", "cifar10", "cifar100")
ARRAY_DATASETS = ("synthetic", "synthetic_cub", "digits")
# The ViTs the JAX training CLI builds (train.py:126); it refuses the rest.
TRAINED_VITS = ("vit_s14", "dinov2_vits14", "vit_s16")
UNTRAINED_VITS = tuple(n for n in VIT_NAMES if n not in TRAINED_VITS)


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
                        "first, in the random and full modes (cluster mode is not "
                        "ported yet), then trains.")
        # I/O
        self.add_argument("--models_dir", default="./", type=str)
        self.add_argument("--data_dir", default="./", type=str)
        self.add_argument("--log_interval", type=int, default=25)
        self.add_argument("--workers", type=int, default=8,
                          help="image-file decode threads (image-file datasets are not "
                               "ported: any other value than 8 is refused)")
        self.add_argument("--decoder", type=str, default="native",
                          choices=["native", "native_fused", "pil"],
                          help="image-file decoder (not ported: only the default is taken)")
        self.add_bool_arg("debug_mode", False)

        # ML
        self.add_argument("--dataset", type=str, required=True,
                          help=f"ported: {', '.join(ARRAY_DATASETS)}")
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
        self.add_argument("--pretrained_path", type=str, default=None)
        self.add_argument("--mesh", type=str, default=None)
        self.add_argument("--train_method", default="nwhead")
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
        """Parse, refuse what is not ported, make the run directory and
        write ``args.txt``."""
        args = self.parse_args(argv)
        if args.platform == "cpu":
            args.device = "cpu"
        check_ported(args)
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


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for every flag
    value the port does not run yet; none is ignored."""
    refused = {
        "--mesh (data-parallel training; ROADMAP.md queue 1, item 14)": args.mesh,
        "--pretrained_path (a local checkpoint file; ROADMAP.md queue 1, item 7)":
            args.pretrained_path,
        f"--bf16 with --arch {args.arch} (the bf16 BatchNorm backbone; ROADMAP.md queue 1, "
        "item 7)": args.bf16 and args.arch not in VIT_NAMES,
        "--train_method fchead (nw/fc.py and FCTrainer; ROADMAP.md queue 1, item 10)":
            args.train_method != "nwhead",
        "--use_wandb (ROADMAP.md queue 1, item 13)": args.use_wandb,
        f"--dataset {args.dataset} (image-file datasets need a download and "
        "data/transforms.py; ROADMAP.md queue 1, item 11)": args.dataset in FILE_DATASETS,
        "--workers/--decoder (image-file decoding; ROADMAP.md queue 1, item 11)":
            args.workers != 8 or args.decoder != "native",
    }
    for flag, hit in refused.items():
        if hit:
            raise NotImplementedError(f"{flag} is not ported yet")
    if args.arch in UNTRAINED_VITS:
        raise NotImplementedError(f"--arch {args.arch}: the training CLI takes the ViTs "
                                  f"{TRAINED_VITS}, as the JAX CLI does")
    if args.dataset not in ARRAY_DATASETS:
        raise NotImplementedError(f"dataset {args.dataset!r} is not ported "
                                  f"(ported: {', '.join(ARRAY_DATASETS)})")
