"""The port's evaluation CLI, ``python -m nwhead_tpu_torch.eval``.

* Two training steps of the training CLI (its per-epoch eval now prints
  cluster mode too), then the eval CLI on the checkpoint with
  ``--modes random full cluster --fit_temperature --influence_queries 2``:
  the result has the JAX CLI's keys (the JAX ``eval.py`` run on the same
  dataset gives them), and its full-mode acc/nll equal a direct
  ``NWNet.predict`` with the loaded weights.
* Refusals name their ROADMAP.md items; ``--device cuda`` without a card
  exits non-zero.
* ``--modes ensemble``, ``knn`` and ``hnsw`` on the CPU, each beside a mode
  it must equal on the 64-row synthetic bank: the one environment's
  ensemble is full mode, knn at ``--n_neighbors 64`` (every row eight
  times in the union) is full mode, and hnsw (its search visits the whole
  small graph) is knn.
* The digits gate (ROADMAP.md queue 1, item 4, gate 1): the digits recipe,
  resnet10, 8 epochs x 40 steps, seed 0, then the eval CLI on the final
  checkpoint: full mode at least 95.7 acc with NLL at most 0.20, cluster
  at least 94.3 (the recorded spreads of both stacks, BASELINE.md, less
  one point of run-to-run variance); knn at least 95.9 and hnsw within 0.3
  of knn (records 96.98-97.53, hnsw equal to knn, ``BASELINE.md:225-253``).
  Needs scikit-learn (the dataset).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nwhead_tpu_torch import eval as eval_cli
from nwhead_tpu_torch import train as train_cli
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import metrics as M
from nwhead_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from nwhead_tpu_torch.train.trainer import NWTrainer, _host_eval_batches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAL_KEYS = {"temperature", "nll_holdout_raw", "nll_holdout_cal", "ece_holdout_raw",
            "ece_holdout_cal"}


def _train_two_steps(tmp_path) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.train", "--device", "cpu",
         "--dataset", "synthetic", "--arch", "resnet10", "--batch_size", "4", "--n_way", "4",
         "--num_epochs", "1", "--num_steps_per_epoch", "2", "--num_val_steps_per_epoch", "2",
         "--log_interval", "1", "--models_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "acc:val:cluster=" in proc.stdout and "ece:val:cluster=" in proc.stdout
    run_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
    return latest_checkpoint(str(run_dir / "checkpoints"))


def _jax_keys() -> dict:
    """The keys of the JAX eval CLI's result for the same modes and flags."""
    import eval as jax_eval_cli

    out = jax_eval_cli.main(["--platform", "cpu", "--dataset", "synthetic", "--arch",
                             "resnet10", "--modes", "random", "full", "cluster",
                             "--fit_temperature", "--num_val_steps", "1"])
    return {mode: set(r) for mode, r in out.items()}


def test_eval_cli_matches_a_direct_predict(tmp_path, capsys):
    ckpt = _train_two_steps(tmp_path)
    results = eval_cli.main(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
                             "--ckpt", ckpt, "--modes", "random", "full", "cluster",
                             "--fit_temperature", "--influence_queries", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == results
    assert lines[0] == f"Loaded checkpoint {ckpt}"
    assert sum(line.startswith("  query ") for line in lines) == 2
    assert {mode: set(r) for mode, r in results.items()} == _jax_keys()
    for r in results.values():
        assert r["n"] == 32 and 0 <= r["acc"] <= 100 and np.isfinite(r["nll"])
        assert CAL_KEYS <= set(r) and r["temperature"] > 0

    # The same numbers from a direct predict with the loaded weights.
    train = tdata.make_synthetic_dataset(n=64, n_classes=4, size=32, seed=0)
    val = tdata.make_synthetic_dataset(n=32, n_classes=4, size=32, seed=1)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=train, device="cpu",
                feat_dim=512)
    net.model.load_state_dict(load_checkpoint(ckpt)["model"])
    net.precompute()
    correct, nll = 0, 0.0
    for img, label in _host_eval_batches(val, 8, None):
        out = net.predict(img, "full")[:len(label)]
        correct += int((out.argmax(1).numpy() == label).sum())
        nll += float(M.nll_loss(out, label)) * len(label)
    assert results["full"]["acc"] == 100.0 * correct / 32
    assert results["full"]["nll"] == pytest.approx(nll / 32, rel=1e-12)


def test_trainer_default_modes_include_cluster():
    train = tdata.make_synthetic_dataset(n=16, n_classes=4, size=8, seed=0)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=train, device="cpu")
    trainer = NWTrainer(net, train, train)
    assert trainer.eval_modes == ("random", "full", "cluster")
    assert "acc:val:cluster" in trainer.val_metrics


@pytest.mark.parametrize("flags,item", [
    (["--bank_cache", "/nonexistent"], "item 11"),
    (["--workers", "4"], "item 11"), (["--decoder", "pil"], "item 11"),
    (["--bf16", "--featurizer_precision", "int8"], "item 8"),
    (["--featurizer_precision", "int8"], "item 8"),
])
def test_eval_cli_refusals_name_their_items(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        eval_cli.main(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10"]
                      + flags)


@pytest.mark.parametrize("flags,same", [
    (["--modes", "full", "ensemble"], "full"),
    (["--modes", "full", "knn", "--n_neighbors", "64"], "full"),
    (["--modes", "knn", "hnsw"], "knn"),
])
def test_eval_cli_runs_the_retrieval_modes(flags, same):
    results = eval_cli.main(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10"]
                            + flags)
    mode = flags[2]
    for r in results.values():
        assert r["n"] == 32 and 0 <= r["acc"] <= 100 and np.isfinite(r["nll"])
    assert results[mode]["acc"] == results[same]["acc"]
    assert results[mode]["nll"] == pytest.approx(results[same]["nll"], rel=1e-5)


def test_eval_cli_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal is for hosts without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_cli.main(["--dataset", "synthetic", "--arch", "resnet10"])
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.eval", "--dataset", "synthetic", "--arch",
         "resnet10"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_digits_gate(tmp_path):
    """Queue 1 item 4, gate 1: the digits recipe through both CLIs."""
    pytest.importorskip("sklearn")
    train_cli.main([
        "--device", "cpu", "--dataset", "digits", "--arch", "resnet10", "--batch_size", "8",
        "--lr", "1e-2", "--n_way", "10", "--n_shot", "1", "--num_epochs", "8",
        "--num_steps_per_epoch", "40", "--scheduler_milestones", "500", "750", "--seed", "0",
        "--log_interval", "8", "--num_val_steps_per_epoch", "1",
        "--models_dir", str(tmp_path)])
    run_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
    ckpt = str(run_dir / "checkpoints" / "model.0008")
    out = eval_cli.main(["--device", "cpu", "--dataset", "digits", "--arch", "resnet10",
                         "--ckpt", ckpt, "--modes", "random", "full", "cluster", "knn",
                         "hnsw", "--fit_temperature"])
    assert out["full"]["n"] == len(tdata.make_digits_dataset(False))
    assert out["full"]["acc"] >= 95.7 and out["full"]["nll"] <= 0.20, out["full"]
    assert out["cluster"]["acc"] >= 94.3, out["cluster"]
    assert out["knn"]["acc"] >= 95.9, out["knn"]
    assert abs(out["hnsw"]["acc"] - out["knn"]["acc"]) <= 0.3, (out["hnsw"], out["knn"])
