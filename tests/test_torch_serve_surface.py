"""The port's serve CLI actions (``nwhead_tpu_torch/serve.py``) against the
root ``serve.py`` of the JAX package, on ResNet-10 over the ``synthetic``
dataset (64 / 32 images of 32 px, 4 classes), the CPU.

* ``--queries`` with ``--topk 3 --temperature 1.5`` over 7 JPEGs at
  ``--batch_size 4`` (a ragged last chunk, padded), and with ``--explain
  3``: JAX's ``answer_queries`` on its net, the port's ``main`` on the same
  weights (``models/convert.py``, written as a checkpoint and loaded by
  ``--ckpt``): the same classes, probabilities within 1e-4 (``TOL``), the
  same ``neighbors`` / ``helpful`` / ``most_harmful`` rows with their
  ``dataset_index``, weights and influences within 1e-4.
* ``--ckpt`` with ``--proj_dim 32`` from the port's training CLI: the
  served log-probs equal the eval CLI's full mode on the same checkpoint,
  and the bank cache's tag carries the path and no seed, as JAX's.
* ``--microbatch_bench`` and ``--jpeg_bench`` run and carry JAX's report
  keys (``device`` in place of ``backend``).
* No action is refused; ``--serve_artifact`` refuses no action and a
  directory with no artifact; ``serving_fn`` lets ``make_serving_fn``'s
  errors through.
"""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

from nwhead_tpu_torch import serve as pserve

torch.set_num_threads(1)

TOL = 1e-4
BASE = ["--dataset", "synthetic", "--arch", "resnet10", "--n_shot_full", "5",
        "--device", "cpu", "--decoder", "pil", "--workers", "1"]


def _jpegs(d, n, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)).save(
            os.path.join(d, f"q{i}.jpg"), quality=90)
    return os.path.join(d, "*.jpg")


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory):
    """The JAX server on ``synthetic`` and its weights written as a port
    checkpoint (``{"model": state_dict}``, the training CLI's layout)."""
    import serve as jserve
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel

    jargs = argparse.Namespace(
        dataset="synthetic", data_dir="./", arch="resnet10", ckpt=None, pretrained_path=None,
        batch_size=4, kernel_type="euclidean", proj_dim=0, n_shot_full=5, bf16=False,
        head_precision="f32", featurizer_precision="f32", calib_images=16,
        fused_inference=False, workers=1, decoder="pil", seed=0, bank_cache=None, mesh=None,
        serve_mode="full", ivf_probe=32, ivf_group=None)
    jnet, variables, jtrain, _ = jserve.build_server(jargs)
    d = tmp_path_factory.mktemp("serve_surface")
    ckpt = str(d / "model.0001")
    torch.save({"model": jax_to_torch_nwmodel(variables)}, ckpt)
    return jserve, jnet, variables, jtrain, jargs, ckpt, _jpegs(str(d / "q"), 7, seed=3)


def _agree_topk(jres, pres):
    assert [r["file"] for r in pres] == [r["file"] for r in jres]
    for j, p in zip(jres, pres):
        assert [t["class"] for t in p["topk"]] == [t["class"] for t in j["topk"]]
        np.testing.assert_allclose([t["prob"] for t in p["topk"]],
                                   [t["prob"] for t in j["topk"]], rtol=0, atol=TOL)


def _agree_rows(jrows, prows, key):
    assert len(prows) == len(jrows)
    for j, p in zip(jrows, prows):
        assert {k: p[k] for k in ("support_index", "label", "dataset_index")} == \
            {k: j[k] for k in ("support_index", "label", "dataset_index")}
        assert p[key] == pytest.approx(j[key], abs=TOL)


@pytest.mark.parametrize("explain", [0, 3])
def test_queries_match_jax(jax_server, explain, capsys):
    """7 files in chunks of 4 (the last ragged, padded to the batch):
    top-3 after temperature 1.5 as JAX's; with ``--explain 3`` the
    explanations too."""
    jserve, jnet, variables, jtrain, jargs, ckpt, pattern = jax_server
    jargs = argparse.Namespace(**{**vars(jargs), "queries": pattern, "topk": 3,
                                  "temperature": 1.5, "explain": explain})
    want = jserve.answer_queries(jnet, variables, jtrain, jargs)
    got = pserve.main(BASE + ["--batch_size", "4", "--ckpt", ckpt, "--queries", pattern,
                              "--topk", "3", "--temperature", "1.5", "--explain", str(explain)])
    got = got["queries"]
    assert len(got) == 7 and len(glob.glob(pattern)) == 7
    _agree_topk(want, got)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["file"] for x in lines[-7:]] == [r["file"] for r in got]
    if not explain:
        assert all("explain" not in r for r in got)
        return
    for j, p in zip(want, got):
        je, pe = j["explain"], p["explain"]
        assert pe["predicted_class"] == je["predicted_class"] == p["topk"][0]["class"]
        assert len(pe["neighbors"]) == 3
        _agree_rows(je["neighbors"], pe["neighbors"], "weight")
        _agree_rows(je["helpful"], pe["helpful"], "influence")
        assert ("most_harmful" in pe) == ("most_harmful" in je)
        if "most_harmful" in je:
            _agree_rows([je["most_harmful"]], [pe["most_harmful"]], "influence")


def test_ckpt_with_proj_dim_serves_the_eval_clis_full_mode(tmp_path):
    """A checkpoint of the port's training CLI with ``--proj_dim 32``: the
    served log-probs equal the eval CLI's full mode on the same checkpoint
    and images; the bank cache is tagged with the path, no seed."""
    from nwhead_tpu_torch import eval as eval_cli
    from nwhead_tpu_torch import train as train_cli
    from nwhead_tpu_torch.data.embedding_cache import FeatureBankCache
    from nwhead_tpu_torch.train.checkpoint import latest_checkpoint

    train_cli.main(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
                    "--batch_size", "4", "--n_way", "4", "--num_epochs", "1",
                    "--num_steps_per_epoch", "2", "--num_val_steps_per_epoch", "1",
                    "--proj_dim", "32", "--log_interval", "1", "--models_dir", str(tmp_path)])
    run_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
    ckpt = latest_checkpoint(str(run_dir / "checkpoints"))
    cache = str(tmp_path / "bank")
    args = pserve.parse_args(BASE + ["--ckpt", ckpt, "--proj_dim", "32", "--batch_size", "8",
                                     "--bank_cache", cache, "--latency_bench"])
    train_ds, val_ds = pserve.build_datasets(args)
    net = pserve.build_server(args, train_ds, val_ds=val_ds)
    assert net.model.proj is not None and net.full_feat.shape[1] == 32
    x = val_ds.gather(np.arange(8))
    served = pserve.serving_fn(net)(x)

    eargs = eval_cli.parse_args(["--device", "cpu", "--dataset", "synthetic", "--arch",
                                 "resnet10", "--n_shot_full", "5", "--proj_dim", "32",
                                 "--ckpt", ckpt, "--modes", "full"])
    enet = eval_cli.build_net(eargs, train_ds)
    torch.testing.assert_close(served, enet.predict(x, "full"), rtol=0, atol=1e-6)
    tag = FeatureBankCache(cache).load_tag()
    assert tag["ckpt"] == ckpt and tag["seed"] == "" and tag["proj_dim"] == "32"
    # Without a checkpoint the seed pins the weights.
    free = pserve.bank_tag(pserve.parse_args(BASE + ["--seed", "3", "--latency_bench"]))
    assert free["ckpt"] == "" and free["seed"] == "3" and free["proj_dim"] == "0"


def test_microbatch_bench_carries_jaxs_report():
    rep = pserve.main(BASE + ["--batch_size", "8", "--microbatch_bench", "--bench_batches",
                              "2", "--concurrency", "4", "--microbatch_wait_ms", "10"])
    rep = rep["microbatch"]
    jax_keys = {"concurrency", "compiled_batch", "max_wait_ms", "requests", "achieved_qps",
                "request_p50_ms", "request_p95_ms", "mean_batch_occupancy",
                "batches_dispatched"}
    assert jax_keys | {"device"} <= set(rep)
    assert rep["requests"] == 4 * 2 * max(4, 8 // 2)
    assert 1 <= rep["mean_batch_occupancy"] <= 8 and rep["batches_dispatched"] >= 4
    assert rep["achieved_qps"] > 0 and rep["device"]["name"] == "cpu"


def test_jpeg_bench_carries_jaxs_report():
    rep = pserve.main(BASE + ["--batch_size", "4", "--jpeg_bench", "--bench_batches", "2",
                              "--workers", "2"])["jpeg"]
    jax_keys = {"batch_size", "batches", "jpeg_hw", "decode_workers", "decoder",
                "pixel_transfer", "decode_img_per_sec", "transfer_img_per_sec",
                "transfer_mb_per_sec", "device_wall_qps", "e2e_qps_from_jpeg", "bound_by",
                "featurizer_precision", "head_precision"}
    assert jax_keys | {"device", "jpeg_source"} <= set(rep)
    assert rep["decoder"] == "pil" and rep["pixel_transfer"] == "uint8"
    assert rep["e2e_qps_from_jpeg"] > 0 and rep["decode_img_per_sec"] > 0
    assert rep["bound_by"] in ("host_decode", "transfer", "device")
    assert rep["jpeg_source"] in ("real", "synthetic")


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="latency_bench.*microbatch_bench.*http"):
        pserve.main(["--dataset", "synthetic", "--arch", "resnet10", "--device", "cpu"])
    # --serve_artifact (ported since): an action is needed, and a directory
    # that holds no artifact is refused before anything is served.
    with pytest.raises(SystemExit, match="--latency_bench and/or --queries"):
        pserve.main(["--dataset", "synthetic", "--serve_artifact", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="meta.json"):
        pserve.main(["--dataset", "synthetic", "--serve_artifact", str(tmp_path),
                     "--latency_bench"])


def test_serving_fn_lets_make_serving_fns_errors_through():
    """No fallback around ``make_serving_fn``: a fused kernel without a
    prepared bank raises; only a kernel with no fused route serves through
    ``predict``, and it has no IVF mode."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=16, n_classes=4, size=16, seed=0)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ds, device="cpu")
    with pytest.raises(ValueError, match="prepared full-mode bank"):
        pserve.serving_fn(net)
    net.kernel_type = "relation"
    with pytest.raises(ValueError, match="fused kernel"):
        pserve.serving_fn(net, mode="ivf")
    assert callable(pserve.serving_fn(net))
