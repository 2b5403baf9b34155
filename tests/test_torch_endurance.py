"""The port's kill-and-resume lab (``nwhead_tpu_torch/labs/endurance_run.py``)
against the JAX package's ``scripts/endurance_run.py``, and the atomic
checkpoint write it relies on.

The lab runs end to end here with ``--device cpu`` (``synthetic``,
ResNet-10, 4 epochs of 8 steps, the lr divided by 10 at epochs 3 and 4, a
checkpoint every 2, killed when epoch 4 starts, ``--poll_s 0.2``; every
training process on one thread). ``kill_at`` is a multiple of ``log_interval``, the case where the JAX script's expected
epoch ``(kill_at // log_interval) * log_interval + 1`` = 5 is wrong: the
newest checkpoint is epoch 2's, and the run resumes at 3. The resumed
run's final checkpoint equals an uninterrupted control run's bit for bit
(JAX's ``test_resume_matches_uninterrupted_control`` on the lab's path):
``synthetic`` has no random transform, so the samplers' generators, which
the sidecar restores, are the only randomness. ``synthetic``'s accuracy is
at 100 from the first epoch, so checks 3 and 4 cannot pass here; the test
holds check 4's numbers instead (the two phases' accuracy at the resumed
epoch equal, the same weights on the CPU). ``scripts/`` and the JAX
package are imported inside the tests.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from nwhead_tpu_torch import train
from nwhead_tpu_torch.labs import endurance_run as E
from nwhead_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAB_ARGV = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10", "--n_way", "0",
            "--epochs", "4", "--kill_at", "4", "--log_interval", "2", "--poll_s", "0.2"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_endurance_run", os.path.join(REPO, "scripts", "endurance_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def lab_run(tmp_path_factory):
    """The lab killed and resumed, and the same recipe uninterrupted, each
    training process on one thread: ``(result, control checkpoints)``."""
    import subprocess

    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        args = E.parser().parse_args(
            LAB_ARGV + ["--models_dir", str(tmp_path_factory.mktemp("split"))])
        result = E.run(args)
        control = E.parser().parse_args(
            LAB_ARGV + ["--models_dir", str(tmp_path_factory.mktemp("control"))])
        subprocess.run(list(E.TRAIN_CMD) + E.recipe_args(control), cwd=E.REPO, check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT, timeout=300)
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    return result, E.checkpoint_dir(control)


@pytest.mark.parametrize("extra", [[], ["--epochs", "20", "--log_interval", "5",
                                        "--models_dir", "runs/e"]])
def test_recipe_args_match_jax(extra):
    """The port's recipe is the JAX script's for the same arguments, plus
    ``--device``; the pass-through flags change only what they name."""
    jax_script = _jax_script()
    args = E.parser().parse_args(extra)
    jax_args = argparse.Namespace(epochs=args.epochs, log_interval=args.log_interval,
                                  models_dir=args.models_dir)
    assert E.recipe_args(args) == jax_script.recipe_args(jax_args) + ["--device", "cuda"]
    args = E.parser().parse_args(extra + ["--dataset", "cifar100", "--n_way", "0",
                                          "--n_shot", "11", "--data_dir", "d",
                                          "--num_steps_per_epoch", "24", "--device", "cpu"])
    got = E.recipe_args(args)
    assert "--n_way" not in got
    assert got[got.index("--dataset") + 1] == "cifar100"
    assert got[-8:] == ["--data_dir", "d", "--n_shot", "11", "--num_steps_per_epoch", "24",
                        "--device", "cpu"]


def test_lab_kills_and_resumes_at_the_epoch_after_the_newest_checkpoint(lab_run):
    """Killed when epoch 4 starts with checkpoints every 2 epochs, the run
    resumes at 3 (JAX's formula says 5), restores the samplers, keeps the
    lr schedule and finishes; at the resumed epoch both phases read the
    same accuracy (the same checkpoint's weights)."""
    result, _ = lab_run
    checks = {name: ok for name, ok, _ in result["checks"]}
    assert result["resumed_at"] == result["expect"] == 3
    assert (4 // 2) * 2 + 1 != result["resumed_at"]
    assert checks["resume epoch"] and checks["lr schedule"] and checks["run completes"]
    full_a = {e: acc for e, _, acc in result["metrics_a"]}
    full_b = {e: acc for e, _, acc in result["metrics_b"]}
    assert sorted(full_a) == [1, 2, 3] and sorted(full_b) == [3, 4]
    assert full_a[3] == full_b[3]
    with open(result["summary"]) as f:
        summary = f.read()
    assert summary.startswith("epochs=4 kill_at=4 resumed_at=3\n")
    assert summary.count("\nOK ") + summary.count("\nFAIL ") == 5


def test_resumed_run_equals_uninterrupted_control(lab_run):
    """The killed-and-resumed run's final checkpoint equals the
    uninterrupted run's, bit for bit: weights, BatchNorm statistics,
    momentum buffers and step."""
    result, control_dir = lab_run
    a = ckpt.load_checkpoint(os.path.join(result["ckpt_dir"], "model.0004"))
    b = ckpt.load_checkpoint(os.path.join(control_dir, "model.0004"))
    assert a["step"] == b["step"] == 32 and a["epoch"] == b["epoch"] == 4
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for ka, kb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert torch.equal(ka["momentum_buffer"], kb["momentum_buffer"])


def test_parse_epoch_metrics_matches_jax(lab_run):
    """Both scripts' ``parse_epoch_metrics`` read the same ``(epoch, lr,
    acc:val:full)`` tuples from the log the port's CLI wrote; the phases'
    parts add up to the whole."""
    result, _ = lab_run
    got = E.parse_epoch_metrics(result["log"])
    assert got == _jax_script().parse_epoch_metrics(result["log"])
    assert got == result["metrics_a"] + result["metrics_b"]
    assert [lr for _, lr, _ in got] == [1e-2, 1e-2, 1e-3, 1e-3, 1e-4]


def test_expected_lr_counts_the_steps_run(lab_run):
    """Check 2's schedule: ``multistep_lr`` over the training split's steps
    an epoch, at ``(epoch - 1)`` times the steps an epoch runs
    (``--num_steps_per_epoch`` caps them); the steps an epoch come from the
    training CLI's log, the training split's rows over the batch."""
    args = E.parser().parse_args(["--epochs", "4"])
    assert [E.expected_lr(args, 8)(e) for e in (1, 2, 3, 4)] == pytest.approx(
        [1e-2, 1e-2, 1e-3, 1e-4], rel=1e-12)
    args = E.parser().parse_args(["--epochs", "4", "--num_steps_per_epoch", "4"])
    assert [E.expected_lr(args, 8)(e) for e in (1, 4)] == [1e-2, 1e-2]
    result, _ = lab_run
    assert E.steps_per_epoch(result["log"]) == len(train.build_datasets(
        train.Parser().parse_args(["--dataset", "synthetic"]))[0]) // E.BATCH_SIZE


# Gate 2's numbers from a run whose accuracy moves (epoch, lr, acc:val:full).
PHASE_A = [(1, 1e-2, 2.5), (2, 1e-2, 74.25), (3, 1e-2, 95.0)]
PHASE_B = [(3, 1e-2, 93.75), (4, 1e-2, 98.0), (5, 1e-2, 98.25), (6, 1e-2, 99.25)]


@pytest.mark.parametrize("case, failing", [
    ("as run", []),
    ("re-initialized", ["weights came back"]),  # phase B reads epoch 1's accuracy at E
    ("kill landed late", ["weights came back"]),
    ("step not restored", ["lr schedule"]),
    ("no steps an epoch logged", ["lr schedule"]),
    ("no progress", ["accuracy moves", "weights came back"]),
])
def test_gate_checks_fail_what_they_guard(case, failing):
    """Each check fails the run it guards against: a re-initialized model,
    a kill after the next save (phase A never printed the resumed epoch),
    an lr off the schedule, accuracy that does not move."""
    args = E.parser().parse_args(["--epochs", "6", "--kill_at", "4", "--log_interval", "2"])
    a, b, resumed, lr_of = list(PHASE_A), list(PHASE_B), 3, lambda e: 1e-2
    if case == "re-initialized":
        b[0] = (3, 1e-2, 3.0)
    elif case == "kill landed late":  # after epoch 4's save: the newest checkpoint is 4
        resumed, b = 5, PHASE_B[2:]
    elif case == "step not restored":
        lr_of = lambda e: 1e-2 if e < 3 else 1e-3  # noqa: E731
    elif case == "no steps an epoch logged":
        lr_of = None
    elif case == "no progress":
        a = [(e, lr, 2.5) for e, lr, _ in a]
        b = [(e, lr, 3.0) for e, lr, _ in b]
    checks = E.gate_checks(args, a, b, resumed, resumed, True, 0, lr_of)
    assert sorted(name for name, ok, _ in checks if not ok) == sorted(failing)


def test_lab_refuses_card_less_cuda(tmp_path):
    """The lab runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.main(["--models_dir", str(tmp_path)])


TRAIN_ARGV = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
              "--batch_size", "4", "--n_way", "4", "--num_steps_per_epoch", "2",
              "--num_val_steps_per_epoch", "1", "--log_interval", "1", "--seed", "3"]


def test_interrupted_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch, capsys):
    """A save interrupted partway (``torch.save`` writes some bytes, then
    ``KeyboardInterrupt``) leaves no ``model.0002``; a temporary file left
    by a killed save is skipped; ``latest_checkpoint`` names epoch 1 and
    ``--resume`` resumes at 2, as JAX's ``latest_checkpoint`` skips orbax's
    ``model.0002.orbax-checkpoint-tmp-1``. A sidecar write interrupted the
    same way leaves the checkpoint, which resumes with fresh samplers."""
    argv = TRAIN_ARGV + ["--models_dir", str(tmp_path), "--num_epochs", "1"]
    trainer = train.main(argv)
    ckpt_dir = os.path.join(train.config.run_dir(train.Parser().parse_args(argv)), "checkpoints")
    first = os.path.join(ckpt_dir, "model.0001")
    assert ckpt.latest_checkpoint(ckpt_dir) == first

    def partial_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 partial")
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(ckpt.torch, "save", partial_save)
        with pytest.raises(KeyboardInterrupt):
            ckpt.save_checkpoint(2, trainer.state_dict(), ckpt_dir)
    assert sorted(os.listdir(ckpt_dir)) == ["model.0001", "model.0001.sampler.json",
                                            "model.best"]
    with open(os.path.join(ckpt_dir, "model.0002" + ckpt.TMP_SUFFIX), "wb") as f:
        f.write(b"PK\x03\x04 killed")  # what a SIGKILL inside a save leaves
    assert ckpt.latest_checkpoint(ckpt_dir) == first
    capsys.readouterr()
    args, _, start = train.setup(argv[:-1] + ["2", "--resume"])
    assert start == 2
    out = capsys.readouterr().out
    assert f"Resumed from {first} at epoch 2" in out and "Restored sampler RNG state" in out

    from nwhead_tpu.train.checkpoint import latest_checkpoint as jax_latest

    jax_dir = tmp_path / "jax"
    (jax_dir / "model.0001").mkdir(parents=True)
    (jax_dir / "model.0002.orbax-checkpoint-tmp-1").mkdir()
    assert jax_latest(str(jax_dir)) == str(jax_dir / "model.0001")

    path = ckpt.save_checkpoint(3, trainer.state_dict(), ckpt_dir)
    with monkeypatch.context() as m:
        m.setattr(json, "dump", lambda *a, **k: (_ for _ in ()).throw(KeyboardInterrupt()))
        with pytest.raises(KeyboardInterrupt):
            ckpt.save_sampler_state(path, {}, {})
    assert ckpt.latest_checkpoint(ckpt_dir) == path
    assert ckpt.load_sampler_state(path) is None
    assert not [n for n in os.listdir(ckpt_dir) if n.startswith("model.0003.")]
    capsys.readouterr()
    train.setup(argv[:-1] + ["3", "--resume"])
    out = capsys.readouterr().out
    assert "at epoch 4" in out and "Restored sampler RNG state" not in out
    assert np.isfinite(ckpt.load_checkpoint(path)["step"])
