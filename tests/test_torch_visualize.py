"""The port's explanation panels (``python -m nwhead_tpu_torch.visualize``):
the CLI writes a PNG, and the explanations it draws equal the ones the JAX
package's panel script draws (``scripts/visualize.py``: its server
namespace, ``serve._build_explainer``) on the same weights and queries:
the same rows, labels and dataset indices, weights and influences within
1e-4. matplotlib runs on the CPU only (the card's machine lacks it)."""

import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytest.importorskip("matplotlib")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def _rows_agree(jrows, prows, key):
    assert len(prows) == len(jrows)
    for j, p in zip(jrows, prows):
        for k in ("support_index", "label", "dataset_index"):
            assert p[k] == j[k]
        assert p[key] == pytest.approx(j[key], abs=TOL)


def test_panels_match_jaxs_explanations(tmp_path, capsys):
    import serve as jserve
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch import visualize
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel

    spec = importlib.util.spec_from_file_location(
        "jax_visualize", os.path.join(REPO, "scripts", "visualize.py"))
    jvis = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jvis)
    ns = type("NS", (), dict(dataset="synthetic", data_dir="./", seed=0, arch="resnet10",
                             kernel_type="euclidean", n_shot_full=100, n_queries=3,
                             ckpt=None))()
    jnet, variables, jtrain, jval = jserve.build_server(jvis.build_args(ns))
    imgs = np.asarray(jval.gather(np.arange(3)))
    _, want = jserve._build_explainer(jnet, jtrain)(variables, imgs, 4)

    ckpt = str(tmp_path / "model.0001")
    torch.save({"model": jax_to_torch_nwmodel(variables)}, ckpt)
    seen = {}
    build = pserve._build_explainer

    def recording(net, train_ds):
        run = build(net, train_ds)

        def wrapped(x, k):
            seen["out"] = run(x, k)
            return seen["out"]

        return wrapped

    out = str(tmp_path / "panels.png")
    with mock.patch.object(pserve, "_build_explainer", recording):
        assert visualize.main(["--dataset", "synthetic", "--arch", "resnet10", "--ckpt", ckpt,
                               "--n_queries", "3", "--topk", "4", "--out", out,
                               "--device", "cpu"]) == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert "3 queries x (1+4+2) panels" in capsys.readouterr().out
    _, got = seen["out"]
    assert len(got) == len(want) == 3
    for j, p in zip(want, got):
        assert p["predicted_class"] == j["predicted_class"]
        _rows_agree(j["neighbors"], p["neighbors"], "weight")
        _rows_agree(j["helpful"], p["helpful"], "influence")
        assert ("most_harmful" in p) == ("most_harmful" in j)
        if "most_harmful" in j:
            _rows_agree([j["most_harmful"]], [p["most_harmful"]], "influence")
