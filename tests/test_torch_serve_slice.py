"""The serving slice end to end: the port's ``NWNet.make_serving_fn`` against
the JAX package's, both nets carrying the same weights, on the ``synthetic``
dataset with resnet10 at 32 px. Probabilities agree within atol=2e-3 and the
argmax agrees on every row. Also the port's serve CLI on the CPU, and the
chunked draw of its synthetic dataset."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu.data.datasets import make_synthetic_dataset as jax_make_synthetic
from nwhead_tpu.models import load_model as jax_load_model
from nwhead_tpu.nw.net import NWNet as JaxNWNet
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_head, jax_to_torch_resnet
from nwhead_tpu_torch.nw.net import NWNet

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kernel,precision", [("euclidean", "f32"), ("clip", "bf16")])
def test_serving_fn_matches_jax(kernel, precision):
    train = jax_make_synthetic(n=64, n_classes=4, size=32, seed=0)
    val = jax_make_synthetic(n=32, n_classes=4, size=32, seed=1)
    jnet = JaxNWNet(jax_load_model("resnet10"), 4, support_dataset=train,
                    kernel_type=kernel, head_precision=precision, fused_min_support=1)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(train.gather(np.arange(8))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(5)  # BN statistics off (0, 1): a non-trivial eval pass
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.standard_normal(v.shape) * 0.1 if path[-1].key == "mean"
                         else rng.random(v.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    if kernel == "clip":
        variables["params"]["head"]["logit_scale"] = np.float32(2.0)
    jnet.precompute(variables)
    x = val.gather(np.arange(16))
    want = np.exp(np.asarray(jnet.make_serving_fn(variables)(jnp.asarray(x))))

    tnet = NWNet(load_model("resnet10", device="cpu"), 4,
                 support_dataset=tdata.make_synthetic_dataset(n=64, n_classes=4, size=32, seed=0),
                 device="cpu", kernel_type=kernel, head_precision=precision,
                 fused_min_support=1)
    tnet.model.featurizer.load_state_dict(jax_to_torch_resnet({
        "params": variables["params"]["featurizer"],
        "batch_stats": variables["batch_stats"]["featurizer"]}))
    tnet.model.head.load_state_dict(jax_to_torch_head(variables["params"].get("head", {})))
    tnet.precompute()
    np.testing.assert_array_equal(tnet._prepared_pos, jnet._prepared_pos)
    got = torch.exp(tnet.make_serving_fn()(x)).numpy()

    assert got.shape == (16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # predict('full') is the same prepared path; a mode without a support set raises.
    np.testing.assert_allclose(torch.exp(tnet.predict(x, mode="full")).numpy(), got, atol=1e-6)
    with pytest.raises(NotImplementedError, match="no support set"):
        tnet.predict(x, mode="nearest")
    # normalize=(mean, std) on uint8 pixels == the float path on (x/255 - mean)/std.
    pix = (np.arange(16 * 32 * 32 * 3) % 251).astype(np.uint8).reshape(16, 32, 32, 3)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    by_norm = tnet.make_serving_fn(normalize=(mean, std))(pix)
    by_hand = tnet.make_serving_fn()(
        ((pix.astype(np.float32) / 255.0 - np.float32(mean)) / np.float32(std)).astype(np.float32))
    np.testing.assert_allclose(by_norm.numpy(), by_hand.numpy(), atol=1e-5)


def test_serve_cli_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.serve", "--device", "cpu",
         "--dataset", "synthetic", "--arch", "resnet10", "--latency_bench",
         "--bench_batches", "2", "--batch_size", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["batches"] == 2 and report["p50_ms"] > 0
    assert report["device"] == {"name": "cpu", "power_limit": None}


def test_digits_dataset_matches_jax():
    pytest.importorskip("sklearn")
    from nwhead_tpu.data.datasets import make_digits_dataset as jax_digits

    for train in (True, False):
        got, want = tdata.make_digits_dataset(train, size=16), jax_digits(train, size=16)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.targets, want.targets)
        np.testing.assert_array_equal(got.gather([3, 1]), want.gather([3, 1]))


def test_synthetic_dataset_chunked_draw_matches_jax(monkeypatch):
    """Drawn in row chunks (here forced to 3 rows), the port's array equals
    the JAX package's single draw bit for bit."""
    monkeypatch.setattr(tdata, "_DRAW_CHUNK_BYTES", 3 * 8 * 8 * 8 * 3)
    for kw in (dict(n=10, n_classes=4, size=8, seed=3),
               dict(n=11, n_classes=5, size=8, seed=4, class_patterns=0.25)):
        got, want = tdata.make_synthetic_dataset(**kw), jax_make_synthetic(**kw)
        assert got.images.dtype == want.images.dtype == np.float32
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.targets, want.targets)
        assert got.num_classes == want.num_classes
