"""The ViT serving slice end to end: the port's ``NWNet.fuse_featurizer``,
``precompute`` and ``make_serving_fn`` against the JAX package's
``NWNet.fuse_featurizer`` + ``predict('full')``, both nets carrying the same
weights (a small ViT: patch 8, D=64, depth 2, 2 heads, LayerScale gammas
of order 1, with and without a projection) on the ``synthetic`` dataset at
32 px. Probabilities agree within atol=2e-3 (measured 1.6e-4) with equal
argmax. Also the serve CLI with ``--featurizer_precision bf16_fused`` on the
CPU, the refusals of what is not ported, and which ViTs the training CLI
takes."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nwhead_tpu.data.datasets import make_synthetic_dataset as jax_make_synthetic
from nwhead_tpu.models import vit as jvit
from nwhead_tpu.nw.net import NWNet as JaxNWNet
from nwhead_tpu_torch import serve
from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models import vit as tvit
from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import fused_attn, fused_mlp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=48)


@pytest.mark.parametrize("proj_dim", [0, 16])
def test_fused_serving_matches_jax(proj_dim):
    train = jax_make_synthetic(n=64, n_classes=4, size=32, seed=0)
    val = jax_make_synthetic(n=32, n_classes=4, size=32, seed=1)
    jnet = JaxNWNet(jvit.VisionTransformer(**SMALL), 4, support_dataset=train, feat_dim=64,
                    proj_dim=proj_dim, fused_min_support=1)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(train.gather(np.arange(4)))))
    rng = np.random.default_rng(7)
    for i in range(SMALL["depth"]):
        for g in ("ls1_gamma", "ls2_gamma"):
            variables["params"]["featurizer"][f"block{i}"][g] = rng.uniform(0.5, 1.5, 64).astype(
                np.float32)
    jnet.fuse_featurizer(variables)
    jnet.precompute(variables)
    x = val.gather(np.arange(16))
    want = np.exp(np.asarray(jnet.predict(variables, jnp.asarray(x), "full")))

    tnet = NWNet(tvit.VisionTransformer(**SMALL), 4,
                 support_dataset=make_synthetic_dataset(n=64, n_classes=4, size=32, seed=0),
                 device="cpu", feat_dim=64, proj_dim=proj_dim, fused_min_support=1)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(variables))
    tnet.fuse_featurizer()
    assert tnet._prepared_full is None  # dropped: the bank must come from the new featurizer
    tnet.precompute()
    got = torch.exp(tnet.make_serving_fn()(x)).numpy()
    assert got.shape == (16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(torch.exp(tnet.predict(x, mode="full")).numpy(), got, atol=1e-6)
    # The bank and the queries went through the fused graph, not the float model.
    with torch.inference_mode():
        float_feats = tnet.model.featurize(torch.from_numpy(x))
        served_feats = tnet._featurize_eval(torch.from_numpy(x))
    assert not torch.equal(float_feats, served_feats)


def test_serve_cli_vit_bf16_fused_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.serve", "--device", "cpu", "--dataset",
         "synthetic", "--arch", "vit_s16", "--featurizer_precision", "bf16_fused",
         "--latency_bench", "--bench_batches", "2", "--batch_size", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["batches"] == 2 and report["p50_ms"] > 0
    assert report["featurizer_precision"] == "bf16_fused" and report["arch"] == "vit_s16"
    assert report["device"] == {"name": "cpu", "power_limit": None}


def test_serve_builds_the_fused_inference_server_on_cpu():
    """``--fused_inference`` builds the ViT on K7/K9 (their plain versions
    on the CPU); ``--bf16`` computes it in bf16."""
    args = serve.parse_args(["--device", "cpu", "--dataset", "synthetic", "--arch", "vit_s16",
                             "--fused_inference", "--bf16", "--batch_size", "4"])
    train_ds, val_ds = serve.build_datasets(args)
    seen = []
    net = serve.build_server(args, train_ds, edit=seen.append)
    assert seen == [net] and net.serving_featurizer is None
    blk = net.model.featurizer.blocks[0]
    assert (blk.attn.attn_impl, blk.mlp.mlp_impl) == ("fused", "fused")
    assert net.model.featurizer.dtype == torch.bfloat16
    assert net.precompute_seconds > 0
    before = fused_attn.attention_qkv_cuda.launches, fused_mlp.mlp_cuda.launches
    out = net.make_serving_fn()(val_ds.gather(np.arange(4)))
    assert out.shape == (4, 4) and bool(torch.isfinite(out).all())
    assert (fused_attn.attention_qkv_cuda.launches, fused_mlp.mlp_cuda.launches) == before


@pytest.mark.parametrize("argv,error,match", [
    (["--featurizer_precision", "int8", "--arch", "resnet10"], NotImplementedError,
     "queue 1, item 8"),
    (["--fused_inference", "--arch", "resnet10"], SystemExit, "ViT archs only"),
    (["--featurizer_precision", "bf16_fused", "--arch", "resnet10"], NotImplementedError,
     "graph is ViT-only"),
    (["--bf16", "--featurizer_precision", "int8", "--arch", "resnet10"], NotImplementedError,
     "queue 1, item 8"),
])
def test_serve_refuses_what_is_not_ported(argv, error, match):
    args = serve.parse_args(["--device", "cpu", "--dataset", "synthetic", "--latency_bench"]
                            + argv)
    with pytest.raises(error, match=match):
        serve.main(["--device", "cpu", "--dataset", "synthetic", "--latency_bench"] + argv)
    with pytest.raises(error, match=match):
        serve.featurizer_options(args)


def test_fuse_featurizer_refuses_a_resnet():
    net = NWNet(load_model("resnet10", device="cpu"), 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ViT"):
        net.fuse_featurizer()


@pytest.mark.parametrize("arch", ["vit_s14", "dinov2_vits14", "vit_s16"])
def test_trainer_takes_the_vits(arch, tmp_path):
    """The training CLI takes the ViTs the JAX CLI trains, with and without
    ``--bf16``."""
    from nwhead_tpu_torch.train.config import Parser

    for extra in ([], ["--bf16"]):
        args = Parser().parse(["--dataset", "synthetic", "--arch", arch, "--device", "cpu",
                               "--models_dir", str(tmp_path), *extra])
        assert args.arch == arch and args.bf16 == bool(extra)


@pytest.mark.parametrize("arch", ["vit_b14", "vit_l14"])
def test_trainer_refuses_the_vits(arch, tmp_path):
    """``vit_b14`` and ``vit_l14`` are refused in training, as the JAX CLI
    refuses them (``train.py:126``)."""
    from nwhead_tpu_torch.train.config import Parser

    with pytest.raises(NotImplementedError, match=arch):
        Parser().parse(["--dataset", "synthetic", "--arch", arch, "--device", "cpu",
                        "--models_dir", str(tmp_path)])


def test_vit_on_cuda_without_a_gpu_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NWNet(tvit.VisionTransformer(**SMALL), 4, device="cuda")
