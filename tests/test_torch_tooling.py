"""The port's tooling against the JAX package's: ``utils.summary``,
``utils/profiling.py`` (``trace``, ``annotate``, ``StepTimer``), the five
legacy samplers of ``nw/samplers.py`` and ``--use_wandb``
(``initialize_wandb`` and the training CLI's logging calls).

* ``summary`` counts what JAX's counts: 16 for a Dense(3 -> 4)
  (``tests/test_utils.py:8``) and JAX's count for ResNet-18 under an NW
  head (the flax tree from ``jax.eval_shape``), with JAX's banner lines.
* ``trace``/``annotate`` write a Chrome trace naming the span
  (``tests/test_utils.py:41``); ``StepTimer`` gives JAX's summary keys and
  its report for the same samples, and ``block=True`` waits on its
  result's device.
* Each sampler yields JAX's indices in JAX's order for the same seed,
  exactly (``tests/test_legacy_parity.py:85-126``), over seeds and two
  label layouts.
* ``initialize_wandb`` raises JAX's ``ImportError`` naming
  ``--no_use_wandb`` without wandb; with a stub ``wandb`` module in
  ``sys.modules`` it makes JAX's calls, and the CLI logs the train and the
  validation metrics once each per epoch.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

torch.set_num_threads(1)

CLI = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10", "--batch_size", "4",
       "--n_way", "4", "--num_steps_per_epoch", "1", "--num_val_steps_per_epoch", "1"]


def _banner(out: str):
    return [line for line in out.splitlines() if line.startswith(("Model Summary", "-----",
                                                                  "Trainable", "Total"))]


def test_summary_counts_a_dense(capsys):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.utils import summary as jsummary
    from nwhead_tpu_torch.utils import summary

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(4)(x)

    m = M()
    want = jsummary(m, m.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))))
    jax_out = capsys.readouterr().out
    assert summary(nn.Linear(3, 4)) == want == 16
    out = capsys.readouterr().out
    assert "Total parameters: 16" in out and "weight (4, 3)" in out
    assert _banner(out) == _banner(jax_out)


def test_summary_counts_resnet18_under_an_nw_head(capsys):
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.models import load_model as jload_model
    from nwhead_tpu.nw.net import NWModel as JNWModel
    from nwhead_tpu.utils import summary as jsummary
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWModel
    from nwhead_tpu_torch.utils import summary

    jmodel = JNWModel(featurizer=jload_model("resnet18"), n_classes=200, kernel_type="clip")
    x, sy = jnp.zeros((1, 32, 32, 3)), jnp.zeros((2,), jnp.int32)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x, jnp.zeros((2, 32, 32, 3)), sy,
                                                  train=False), jax.random.PRNGKey(0))
    want = jsummary(jmodel, shapes)
    capsys.readouterr()
    got = summary(NWModel(load_model("resnet18", device="cpu"), 200, "clip"))
    assert got == want > 11_000_000
    assert f"Total parameters: {want}" in capsys.readouterr().out


def test_trace_writes_the_span(tmp_path):
    from nwhead_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)) as prof:
        with annotate("phase"):
            torch.ones((8, 8)).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "phase" for e in events)
    assert any(e.key == "phase" for e in prof.key_averages())


def test_step_timer_matches_jax(monkeypatch):
    from nwhead_tpu.utils.profiling import StepTimer as JStepTimer
    from nwhead_tpu_torch.utils import profiling
    from nwhead_tpu_torch.utils.profiling import StepTimer

    timers = StepTimer(), JStepTimer()
    for t in timers:
        for name, seconds in (("b", 0.5), ("b", 0.25), ("a", 0.125), ("b", 1.0)):
            t.record(name, seconds)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].report() == timers[1].report()
    assert set(timers[0].summary()["b"]) == {"mean_ms", "p50_ms", "p95_ms", "total_s", "count"}
    waited = []
    monkeypatch.setattr(profiling, "_sync", waited.append)
    t = StepTimer()
    out = [torch.zeros(2)]
    with t.phase("step", result=out, block=True):
        out.append(torch.ones(2))
    with t.phase("host"):
        pass
    assert waited == [out] and t.summary()["step"]["count"] == 1 and "host" in t.report()


SAMPLER_CASES = [
    ("QuerySampler", {}),
    ("RandomSupportSampler", dict(n_support=8, num_batches=5)),
    ("QuerySupportSampler", dict(n_shot=2)),
    ("SubsampleQuerySupportSampler", dict(n_shot=2, subsample_size=3, num_batches=10)),
    ("QuerySupportBatchSampler", dict(batch_size=4, n_shot=1, n_way=3)),
    ("QuerySupportBatchSampler", dict(batch_size=4, n_shot=2)),
]


def _drawn(sampler):
    def plain(x):
        return [plain(v) for v in x] if isinstance(x, (tuple, list)) else np.asarray(x).tolist()

    return [plain(item) for item in sampler]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("layout", ["grouped", "shuffled"])
@pytest.mark.parametrize("name,kw", SAMPLER_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SAMPLER_CASES)])
def test_samplers_pick_jax_indices(name, kw, seed, layout):
    from nwhead_tpu.nw import samplers as jsamplers
    from nwhead_tpu_torch.nw import samplers

    targets = np.repeat(np.arange(5), 6)
    if layout == "shuffled":  # labels 3..7 out of order, one class larger
        targets = np.random.default_rng(11).permutation(np.concatenate([targets, [2]])) + 3
    got = _drawn(getattr(samplers, name)(targets, seed=seed, **kw))
    want = _drawn(getattr(jsamplers, name)(targets, seed=seed, **kw))
    assert len(got) == len(getattr(samplers, name)(targets, seed=seed, **kw)) > 0
    assert got == want


def test_initialize_wandb_without_wandb(monkeypatch):
    from nwhead_tpu.train.config import initialize_wandb as jinit
    from nwhead_tpu_torch.train.config import initialize_wandb

    monkeypatch.setitem(sys.modules, "wandb", None)
    args = types.SimpleNamespace(wandb_api_key_path=None, wandb_kwargs={})
    for init in (initialize_wandb, jinit):
        with pytest.raises(ImportError, match="--no_use_wandb"):
            init(args)


def _stub_wandb(calls: list):
    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: calls.append(("init", kw))
    wandb.log = lambda d: calls.append(("log", dict(d)))
    wandb.config = types.SimpleNamespace(update=lambda c: calls.append(("config", vars(c))))
    return wandb


def test_wandb_calls_match_jax(monkeypatch, tmp_path):
    from nwhead_tpu.train.config import initialize_wandb as jinit
    from nwhead_tpu_torch.train import main as train_main
    from nwhead_tpu_torch.train.config import initialize_wandb

    key = tmp_path / "key"
    key.write_text("secret\n")
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    args = types.SimpleNamespace(wandb_api_key_path=str(key), wandb_kwargs={"project": "nw"})
    got, want = [], []
    for init, calls in ((initialize_wandb, got), (jinit, want)):
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
        init(args)
    assert got == want == [("init", {"project": "nw"}), ("config", vars(args))]
    assert os.environ["WANDB_API_KEY"] == "secret"

    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
    trainer = train_main(CLI + ["--num_epochs", "2", "--use_wandb", "--wandb_kwargs",
                                "project=nw", "--models_dir", str(tmp_path / "runs")])
    kinds = [c[0] for c in calls]
    assert kinds == ["init", "config", "log", "log", "log", "log"]
    assert calls[0][1] == {"project": "nw"} and calls[1][1]["use_wandb"] is True
    assert set(calls[2][1]) == set(trainer.metrics) == {"loss:train", "acc:train"}
    assert set(calls[3][1]) == set(trainer.val_metrics) == {
        f"{n}:val:{m}" for n in ("loss", "acc", "ece") for m in ("random", "full", "cluster")}
    assert all(np.isfinite(v) for _, d in calls[2:] for v in d.values())
