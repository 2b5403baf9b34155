"""The serve CLI's AOT artifact (``--export_artifact`` /
``--serve_artifact``, ``tests/test_aot.py``'s two CLI cases) on the CPU:
the CLI exports and then serves with no model build, single-device and
under ``--mesh 2,4`` (eight copies of the CPU device, the mesh program);
and the CLI's ``export_artifact`` on a server carrying JAX's serve-CLI
weights, whose reloaded program equals the port's live callable within
``ART_TOL`` (1e-6; 1e-3 / 1e-4 with the same argmax for the mesh, JAX's),
which matches JAX's live serving fn within ``JAX_TOL`` (2e-3 on
probabilities, the same argmax); ``--serve_artifact --queries`` on JPEG
files, each file's top-k the live callable's. Shared helpers:
``tests/torch_aot_cases.py``."""

import argparse
import os

import numpy as np
import torch

import jax

from torch_aot_cases import ART_TOL, live_matches_jax

torch.set_num_threads(1)


def _jax_args(**kw):
    """The JAX serve CLI's namespace for ``build_server``."""
    base = dict(
        dataset="synthetic", data_dir="./", arch="resnet10", ckpt=None, pretrained_path=None,
        batch_size=4, kernel_type="euclidean", proj_dim=0, n_shot_full=5, bf16=False,
        head_precision="f32", featurizer_precision="f32", calib_images=16,
        fused_inference=False, workers=1, decoder="pil", seed=0, bank_cache=None, mesh=None,
        serve_mode="full", ivf_probe=32, ivf_group=None)
    return argparse.Namespace(**{**base, **kw})


def _carried_server(argv, jargs):
    """JAX's ``build_server`` and the port's on JAX's weights (the CLI's
    ``edit=`` hook): ``(jnet, variables, args, net, train, val)``."""
    import serve as jserve
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel

    jnet, variables, _, _ = jserve.build_server(jargs)
    state = jax_to_torch_nwmodel(jax.tree_util.tree_map(np.asarray, variables))
    args = pserve.parse_args(argv)
    train, val = pserve.build_datasets(args)
    net = pserve.build_server(args, train, edit=lambda n: n.model.load_state_dict(state),
                              val_ds=val)
    return jnet, variables, args, net, train, val


def test_cli_export_then_serve_artifact(tmp_path):
    """``--export_artifact`` then ``--serve_artifact --latency_bench`` (no
    model build); and the CLI's ``export_artifact`` on a server carrying
    JAX's serve-CLI weights: the reloaded program equals the port's live
    callable, which matches JAX's."""
    import serve as jserve
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.utils.aot import load_serving_artifact

    art = str(tmp_path / "artifact")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
            "--batch_size", "4", "--n_shot_full", "5"]
    rep = pserve.main(argv + ["--export_artifact", art])
    assert rep["exported"] == art and os.path.exists(os.path.join(art, "program.pt2"))
    assert rep["input_dtype"] == "uint8" and rep["arch"] == "resnet10"
    out = pserve.main(["--dataset", "synthetic", "--serve_artifact", art, "--latency_bench",
                       "--bench_batches", "2"])
    lat = out["latency"]
    assert lat["batch_size"] == 4 and lat["queries_per_sec"] > 0 and lat["backend"] == "cpu"
    assert lat["p50_ms"] > 0 and lat["p95_ms"] >= lat["p50_ms"]

    jnet, variables, args, net, train, val = _carried_server(
        argv + ["--export_artifact", str(tmp_path / "carried")], _jax_args())
    pserve.export_artifact(net, train, val, args)
    q = np.random.default_rng(2).integers(0, 256, size=(4, 32, 32, 3)).astype(np.uint8)
    live = live_matches_jax(pserve.serving_fn(net, uint8_normalize=True),
                             jserve.serving_fn(jnet, variables, uint8_normalize=True), q)
    got = load_serving_artifact(str(tmp_path / "carried"))(q).numpy()
    np.testing.assert_allclose(got, live, rtol=ART_TOL, atol=ART_TOL)


def test_cli_mesh_export_then_serve_artifact(tmp_path):
    """``--mesh 2,4 --export_artifact`` writes the mesh program (eight
    devices); ``--serve_artifact`` detects it and serves. On JAX's weights
    the reloaded mesh program matches the port's live mesh callable (raw
    shards live, prepared shards in the artifact: JAX's 1e-3 / 1e-4, the
    same argmax), which matches JAX's."""
    import serve as jserve
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.utils.aot import load_mesh_serving_artifact

    art = str(tmp_path / "mesh_artifact")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
            "--batch_size", "8", "--n_shot_full", "5", "--mesh", "2,4"]
    rep = pserve.main(argv + ["--export_artifact", art])
    assert rep["exported"] == art and rep["nr_devices"] == 8
    assert rep["mesh_shape"] == [2, 4, 1]
    out = pserve.main(["--dataset", "synthetic", "--serve_artifact", art, "--latency_bench",
                       "--bench_batches", "2"])
    assert out["latency"]["batch_size"] == 8 and out["latency"]["queries_per_sec"] > 0

    jnet, variables, args, net, train, val = _carried_server(
        argv + ["--export_artifact", str(tmp_path / "carried")],
        _jax_args(batch_size=8, mesh="2,4"))
    pserve.export_artifact(net, train, val, args)
    q = np.random.default_rng(3).integers(0, 256, size=(8, 32, 32, 3)).astype(np.uint8)
    live = live_matches_jax(pserve.serving_fn(net, uint8_normalize=True),
                             jserve.serving_fn(jnet, variables, uint8_normalize=True), q)
    got = load_mesh_serving_artifact(str(tmp_path / "carried"))(q).numpy()
    np.testing.assert_allclose(got, live, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), live.argmax(-1))


def test_cli_serve_artifact_queries(tmp_path):
    """``--serve_artifact --queries``: image files decoded by PIL through the
    eval transform at the artifact's height, answered in chunks of its
    batch (the last padded), each file's top-k the live serving callable's
    on the same pixels."""
    from PIL import Image

    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.data import transforms as T
    from nwhead_tpu_torch.data.datasets import ImageFileDataset

    rng = np.random.default_rng(4)
    paths = []
    for i in range(5):
        path = tmp_path / f"q{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
            "--batch_size", "4", "--n_shot_full", "5"]
    art = str(tmp_path / "art")
    args = pserve.parse_args(argv + ["--export_artifact", art])
    train, val = pserve.build_datasets(args)
    net = pserve.build_server(args, train, val_ds=val)
    pserve.export_artifact(net, train, val, args)
    out = pserve.main(["--dataset", "synthetic", "--serve_artifact", art, "--queries",
                       str(tmp_path / "*.jpg"), "--topk", "3", "--decoder", "pil",
                       "--workers", "1"])
    answers = out["queries"]
    assert [a["file"] for a in answers] == paths
    pix = ImageFileDataset(paths, np.zeros(5, np.int64), 4, decoder="pil", workers=1,
                           transform=T.imagenet_eval_transform(32, device_normalize=True)
                           ).gather(np.arange(5))
    live = pserve.serving_fn(net, uint8_normalize=True)
    want = np.concatenate([live(pix[:4]).numpy(),
                           live(np.concatenate([pix[4:], np.zeros_like(pix[:3])])).numpy()[:1]])
    for a, row in zip(answers, want):
        top = np.argsort(-row)[:3]
        assert [t["class"] for t in a["topk"]] == top.tolist()
        np.testing.assert_allclose([t["prob"] for t in a["topk"]],
                                   np.round(np.exp(row[top]), 4), atol=1e-4)
