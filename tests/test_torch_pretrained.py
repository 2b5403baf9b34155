"""``--pretrained_path``: local torchvision- and DINOv2-format checkpoints
through the port's ``load_model(..., pretrained=path)`` and the JAX
package's ``load_model(..., pretrained=path)`` with its init-time merge
(``merge_backbone_pretrained``), and the three CLIs on the CPU.

The state dicts come from ``tests/torch_oracles.py``'s torchvision-named
ResNet-50, ResNeXt-50 32x4d and DenseNet-121 (running statistics drawn off
(0, 1), plus classifier keys that both loaders must ignore), written as
``.pth``, as a ``{"state_dict": ...}`` wrapper and as ``.npz``; one
DenseNet file has the legacy ``norm.1``-style keys. A DINOv2-named ViT
state dict is the port's ViT-S/14 renamed, LayerScale gammas of order 1.
Eval-mode features: the port against the oracle itself at rtol=1e-4,
atol=1e-4 (the same torch convolutions), the port against JAX at
rtol=1e-3, atol=5e-3 (``tests/test_torch_resnet.py``'s bound), the ViT at
rtol=atol=1e-4 (``tests/test_torch_vit.py``'s f32 bound).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nwhead_tpu.models import load_model as jax_load_model
from nwhead_tpu.models.torch_import import merge_backbone_pretrained
from nwhead_tpu_torch import eval as eval_cli
from nwhead_tpu_torch import serve
from nwhead_tpu_torch import train as train_cli
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models import pretrained as P
from nwhead_tpu_torch.train.config import Parser, cifar_name, featurizer_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_oracles import (  # noqa: E402
    torch_densenet121, torch_resnet18, torch_resnet50, torch_resnext50_32x4d,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=5e-3)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLES = {"resnet50": (torch_resnet50, "fc"), "resnext50_32x4d": (torch_resnext50_32x4d, "fc"),
           "densenet121": (torch_densenet121, "classifier")}


def _x(size, seed=0, n=2):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _oracle_state(make, head, seed=0):
    """The oracle's weights (torch's init under ``seed``), its running
    statistics drawn off (0, 1), and a classifier the loaders must ignore."""
    torch.manual_seed(seed)
    model = make()
    sd = model.state_dict()
    g = torch.Generator().manual_seed(7 + seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
    model.load_state_dict(sd)
    sd = dict(model.state_dict())
    sd[f"{head}.weight"] = torch.randn(10, 7, generator=g)
    sd[f"{head}.bias"] = torch.randn(10, generator=g)
    return model.eval(), sd


def _write(sd, path, fmt):
    if fmt == "pth":
        torch.save(sd, path)
    elif fmt == "wrapped":
        torch.save({"state_dict": sd, "epoch": 3}, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return str(path)


def _jax_features(name, path, x):
    """JAX's ``load_model(name, pretrained=path)``, its variables merged at
    init time (on an abstract init's zeros: the file covers every weight),
    applied in eval mode."""
    model = jax_load_model(name, pretrained=path)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
                            jnp.asarray(x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = {"params": {"featurizer": zeros["params"]}}
    if "batch_stats" in zeros:
        variables["batch_stats"] = {"featurizer": zeros["batch_stats"]}
    merged = merge_backbone_pretrained(variables, model)
    feat = {k: v["featurizer"] for k, v in merged.items()}
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(feat, jnp.asarray(x)))


@pytest.mark.parametrize("arch", list(ORACLES))
def test_pretrained_file_matches_jax(arch, tmp_path):
    """The three file formats load the same weights; classifier keys and
    ``num_batches_tracked`` are ignored; the features equal the oracle's and
    JAX's from the same file."""
    make, head = ORACLES[arch]
    oracle, sd = _oracle_state(make, head)
    paths = [_write(sd, tmp_path / f"w.{fmt}.{'npz' if fmt == 'npz' else 'pth'}", fmt)
             for fmt in ("pth", "wrapped", "npz")]
    nets = [load_model(arch, device="cpu", pretrained=p) for p in paths]
    for net, path in zip(nets, paths):
        assert net.pretrained_path == path and not net.training
        for k, v in net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[k]), (path, k)
    x = _x(32)
    with torch.no_grad():
        got = nets[0](torch.from_numpy(x)).numpy()
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, **ORACLE_TOL)
    np.testing.assert_allclose(got, _jax_features(arch, paths[2], x), **TOL)


def test_legacy_densenet_keys(tmp_path):
    """``denselayerN.norm.1.weight``-style keys (the old torchvision names)
    load as ``norm1.weight`` in both packages."""
    oracle, sd = _oracle_state(torch_densenet121, "classifier", seed=1)
    legacy = {}  # the old files predate num_batches_tracked
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".denselayer" in k:
            k = k.replace(".norm1.", ".norm.1.").replace(".conv1.", ".conv.1.")
            k = k.replace(".norm2.", ".norm.2.").replace(".conv2.", ".conv.2.")
        legacy[k] = v
    assert "features.denseblock1.denselayer1.norm.1.weight" in legacy
    assert set(P.remap_densenet_legacy(legacy)) == {
        k for k in sd if not k.endswith("num_batches_tracked")}
    path = _write(legacy, tmp_path / "legacy.pth", "pth")
    net = load_model("densenet121", device="cpu", pretrained=path)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    x = _x(32, seed=1)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_features("densenet121", path, x), **TOL)


def test_dinov2_vit_file_matches_jax(tmp_path):
    """A DINOv2-named state dict (``patch_embed.proj.*``, ``ls1.gamma``,
    ``mask_token``, ``head.*``) into the port's ViT-S/14 and JAX's."""
    src = load_model("dinov2_vits14", device="cpu", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in src.blocks:
            blk.ls1_gamma.uniform_(0.5, 1.5, generator=g)
            blk.ls2_gamma.uniform_(0.5, 1.5, generator=g)
    dino = {}
    for k, v in src.state_dict().items():
        k = k.replace("patch_embed.", "patch_embed.proj.")
        k = k.replace("ls1_gamma", "ls1.gamma").replace("ls2_gamma", "ls2.gamma")
        dino[k] = v
    dino["mask_token"] = torch.zeros(1, 384)
    dino["head.weight"], dino["head.bias"] = torch.randn(5, 384, generator=g), torch.zeros(5)
    assert P.convert_dinov2_state_dict(dino).keys() == src.state_dict().keys()
    path = _write(dino, tmp_path / "dinov2.pth", "pth")
    net = load_model("dinov2_vits14", device="cpu", pretrained=path)
    for k, v in net.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    x = _x(28, seed=2)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_features("dinov2_vits14", path, x), rtol=1e-4, atol=1e-4)


def test_conv7_file_into_s2d_model(tmp_path):
    """A 7x7 stem checkpoint merged into an ``s2d`` model goes through
    ``s2d_stem_kernel``: the same features as the conv7 model."""
    _, sd = _oracle_state(torch_resnet50, "fc", seed=2)
    path = _write(sd, tmp_path / "r50.pth", "pth")
    conv7 = load_model("resnet50", device="cpu", pretrained=path)
    s2d = load_model("resnet50", device="cpu", stem="s2d", pretrained=path)
    assert tuple(s2d.conv1.weight.shape) == (64, 12, 4, 4)
    x = _x(64, seed=3)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(torch.from_numpy(x)).numpy(),
                                   conv7(torch.from_numpy(x)).numpy(), rtol=1e-4, atol=1e-4)


def test_merge_is_strict_false(tmp_path):
    """Missing keys keep their init, unknown keys are reported and skipped,
    a shape that differs raises, and ``pretrained=True`` needs a path."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    fresh = load_model("resnet18", device="cpu", generator=gen())
    stem = torch.randn(64, 3, 7, 7)
    path = _write({"conv1.weight": stem, "extra.weight": torch.ones(3)}, tmp_path / "p.pth", "pth")
    net = load_model("resnet18", device="cpu", generator=gen(), pretrained=path)
    assert torch.equal(net.conv1.weight, stem)
    for k, v in fresh.state_dict().items():
        if k != "conv1.weight":
            assert torch.equal(net.state_dict()[k], v), k
    report = P.load_pretrained(fresh, P.load_state_dict_file(path))
    assert report["loaded"] == ["conv1.weight"] and report["ignored"] == ["extra.weight"]
    assert "layer1.0.conv1.weight" in report["missing"]
    _, sd18 = _oracle_state(torch_resnet18, "fc")
    bad = _write(sd18, tmp_path / "r18.pth", "pth")
    with pytest.raises(ValueError, match="shape"):
        load_model("resnet50", device="cpu", pretrained=bad)
    with pytest.raises(ValueError, match="needs a checkpoint path"):
        load_model("resnet18", device="cpu", pretrained=True)


def _resnet18_file(tmp_path):
    _, sd = _oracle_state(torch_resnet18, "fc", seed=4)
    return sd, _write(sd, tmp_path / "r18.pth", "pth")


def _assert_loaded(featurizer, sd):
    for k, v in featurizer.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v.cpu(), sd[k]), k


def test_train_cli_with_pretrained_path(tmp_path):
    """One epoch of 2 steps on ``synthetic``, ResNet-18 from a torchvision
    file, in bf16 (``--bf16`` on a CNN): the built featurizer holds the
    file's weights, the steps run and move them."""
    sd, path = _resnet18_file(tmp_path)
    args, trainer, start = train_cli.setup([
        "--device", "cpu", "--dataset", "synthetic", "--arch", "resnet18", "--batch_size", "4",
        "--n_way", "4", "--num_epochs", "1", "--num_steps_per_epoch", "2",
        "--num_val_steps_per_epoch", "1", "--models_dir", str(tmp_path), "--bf16",
        "--pretrained_path", path])
    featurizer = trainer.net.model.featurizer
    assert featurizer.pretrained_path == path and featurizer.dtype == torch.bfloat16
    _assert_loaded(featurizer, sd)
    train_cli.run_epochs(args, trainer, start)
    assert trainer.step == 2 and np.isfinite(trainer.step_losses).all()
    assert not torch.equal(featurizer.conv1.weight, sd["conv1.weight"])


def test_eval_cli_with_pretrained_path(tmp_path):
    sd, path = _resnet18_file(tmp_path)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet18", "--modes", "full",
            "--pretrained_path", path]
    results = eval_cli.main(argv)
    assert results["full"]["n"] == 32 and np.isfinite(results["full"]["nll"])
    args = eval_cli.parse_args(argv)
    net = eval_cli.build_net(args, train_cli.build_datasets(args)[0])
    _assert_loaded(net.model.featurizer, sd)


def test_serve_cli_with_pretrained_path(tmp_path):
    sd, path = _resnet18_file(tmp_path)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet18", "--latency_bench",
            "--bench_batches", "2", "--batch_size", "8", "--pretrained_path", path]
    report = serve.main(argv)["latency"]
    assert report["pretrained_path"] == path and report["batches"] == 2
    args = serve.parse_args(argv)
    train_ds, _ = serve.build_datasets(args)
    net = serve.build_server(args, train_ds)
    _assert_loaded(net.model.featurizer, sd)


def test_cli_surface():
    """``--bf16`` on a CNN is taken by all three CLIs; the training CLI builds
    the JAX CLI's archs only (``train.py:121-129``) and maps resnet18 and
    densenet121 to their CIFAR models on CIFAR, as the eval CLI does
    (``eval.py:106-108``); bf16_fused stays ViT-only."""
    for arch in ("resnet50", "densenet121"):
        opts = serve.featurizer_options(serve.parse_args(
            ["--dataset", "synthetic", "--arch", arch, "--bf16"]))
        assert opts == {"dtype": torch.bfloat16}
        eval_cli.check_ported(eval_cli.parse_args(
            ["--device", "cpu", "--dataset", "synthetic", "--arch", arch, "--bf16"]))
    with pytest.raises(NotImplementedError, match="graph is ViT-only"):
        serve.featurizer_options(serve.parse_args(
            ["--dataset", "synthetic", "--arch", "densenet121", "--featurizer_precision",
             "bf16_fused"]))
    jax_map = {("resnet18", "cifar10"): "CIFAR_ResNet18",
               ("resnet18", "cifar100"): "CIFAR_ResNet18",
               ("densenet121", "cifar10"): "CIFAR_DenseNet121", ("resnet18", "bird"): "resnet18",
               ("densenet121", "synthetic"): "densenet121", ("resnet50", "cifar10"): "resnet50",
               ("resnet34", "bird"): "resnet34", ("resnet10", "digits"): "resnet10",
               ("vit_s14", "cifar10"): "vit_s14", ("dinov2_vits14", "bird"): "dinov2_vits14",
               ("vit_s16", "synthetic"): "vit_s16"}
    for (arch, dataset), name in jax_map.items():
        assert featurizer_name(arch, dataset) == name == cifar_name(arch, dataset)
    for arch in ("resnet101", "resnext50_32x4d", "densenet161", "CIFAR_ResNet18", "vit_b14"):
        with pytest.raises(NotImplementedError, match=arch):
            featurizer_name(arch, "synthetic")
    assert cifar_name("resnet101", "cifar10") == "resnet101"


def test_train_cli_refuses_resnet101(tmp_path):
    with pytest.raises(NotImplementedError, match="resnet101"):
        Parser().parse(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet101",
                        "--models_dir", str(tmp_path)])
    args = Parser().parse(["--device", "cpu", "--dataset", "synthetic", "--arch", "densenet121",
                           "--bf16", "--models_dir", str(tmp_path)])
    assert args.bf16 and args.arch == "densenet121"
