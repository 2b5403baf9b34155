"""The training slice of the port against the JAX package.

* Episode index streams (``SupportSetTrain`` + ``EpisodicBatcher``, the
  trainer's seeding chain) equal JAX's, bit for bit, for ``random`` with and
  without ``n_way`` and for ``irm``, over 2 epochs.
* ``ops.metrics`` equals JAX's (rtol 1e-6).
* Two ``NWTrainer`` steps from the same weights carried across with
  ``jax_to_torch_nwmodel``: ResNet-10 at 16 px, B=4, a 16-row episode with
  ``fused_min_support=16`` (the fused K1/K3 path; JAX runs its Pallas
  kernels in interpret mode) and once on the naive path. Mean loss at
  rtol=1e-4; every parameter and BatchNorm running statistic within 1% of
  how far the JAX step moved it (the two f32 featurizers already differ by
  up to 1e-3 relative in their features, tests/test_torch_resnet.py, and
  clip's scale of about 14 amplifies that in the early layers' gradients);
  log-probs on a fixed episode afterwards at rtol=atol=2e-3 (2e-5 is
  reached on the euclidean case; clip's scale multiplies the cosines'
  differences); then eval in the random and full modes gives the same
  loss, accuracy and ECE (rtol 2e-3). At 16 px the
  last blocks' BatchNorm sees 20 values per channel, so the biased versus
  unbiased running variance (a 5% difference of its batch term) would
  show.
* The learning-rate schedule crosses its milestone at optax's step.
* ``freeze_featurizer``: with wd=0 it matches JAX; with wd>0 the port's
  featurizer parameters do not move at all.
* The CLI on the CPU, its refusals, and resume equal to an uninterrupted
  run (port only, bitwise).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.data import pipeline as tpipe
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
from nwhead_tpu_torch.nw import support as tsupport
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import metrics as tmetrics
from nwhead_tpu_torch.train import main as train_main
from nwhead_tpu_torch.train import setup as train_setup
from nwhead_tpu_torch.train.trainer import NWTrainer, multistep_lr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_REL = 1e-2  # of the JAX update's size, per tensor


def _stream(support_mod, pipeline_mod, train_type, n_way, env_array):
    ds = tdata.make_synthetic_dataset(n=60, n_classes=6, size=4, seed=0)
    st = support_mod.SupportSetTrain(np.asarray(ds.targets), 6, train_type, n_shot=2,
                                     n_way=n_way, env_array=env_array, seed=3)
    rng = np.random.default_rng(5)  # the trainer's generator: one batcher seed per epoch
    steps = []
    for _ in range(2):
        batcher = pipeline_mod.EpisodicBatcher(ds, st, 4, seed=int(rng.integers(0, 2**31 - 1)))
        steps += [tuple(np.asarray(x).tolist() for x in step) for step in batcher.epoch_indices()]
    return steps


@pytest.mark.parametrize("train_type,n_way,irm_envs", [
    ("random", 4, False), ("random", None, False), ("irm", None, True)])
def test_episode_streams_match_jax(train_type, n_way, irm_envs):
    from nwhead_tpu.data import pipeline as jpipe
    from nwhead_tpu.nw import support as jsupport

    env = np.arange(60) % 3 if irm_envs else None
    got = _stream(tsupport, tpipe, train_type, n_way, env)
    want = _stream(jsupport, jpipe, train_type, n_way, env)
    assert len(got) == 2 * 15 and got == want


def test_metrics_match_jax():
    from nwhead_tpu.ops import metrics as jm

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 5)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    y = rng.integers(0, 5, 50)
    onehot = np.eye(5, dtype=np.float32)[y]
    scores = np.round(rng.random(50), 1).astype(np.float32)  # ties: midranks
    binary = (rng.random(50) > 0.5).astype(np.int64)
    weight = rng.random(5).astype(np.float32)
    lp, tgt = torch.from_numpy(log_probs), torch.from_numpy(y)
    pairs = [
        (tmetrics.acc(lp.argmax(1), tgt), jm.acc(jnp.argmax(log_probs, 1), y)),
        (tmetrics.roc(scores, binary), jm.roc(scores, binary)),
        (tmetrics.ece(np.exp(log_probs), y), jm.ece(np.exp(log_probs), y)),
        (tmetrics.nll_loss(lp, tgt), jm.nll_loss(log_probs, y)),
        (tmetrics.nll_loss_onehot(lp, torch.from_numpy(onehot)), jm.nll_loss_onehot(log_probs, onehot)),
        (tmetrics.label_smoothing_loss_onehot(lp, torch.from_numpy(onehot), 0.2),
         jm.label_smoothing_loss_onehot(log_probs, onehot, 0.2)),
        (tmetrics.smooth_nll_loss(lp, tgt, 0.1, weight=torch.from_numpy(weight)),
         jm.smooth_nll_loss(log_probs, y, 0.1, weight=weight)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    tm, jmm = tmetrics.Metric(), jm.Metric()
    for v, n in ((0.5, 3), (2.0, 1)):
        tm.update_state(torch.tensor(v), n)
        jmm.update_state(v, n)
    assert tm.result() == jmm.result()


def _trainers(kernel, fused, *, freeze=False, wd=1e-4):
    """A JAX and a port trainer on the same data, episodes and weights."""
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.train import NWTrainer as JNWTrainer

    common = dict(n_shot=4, kernel_type=kernel, fused_min_support=16 if fused else 1024, seed=0)
    tkw = dict(lr=0.05, batch_size=4, milestones=(100,), weight_decay=wd,
               freeze_featurizer=freeze, eval_modes=("random", "full"), seed=0)
    jtrain, jval = jsyn(n=48, n_classes=4, size=16, seed=0), jsyn(n=16, n_classes=4, size=16, seed=1)
    jtr = JNWTrainer(JNWNet(jload("resnet10"), 4, support_dataset=jtrain, **common),
                     jtrain, jval, **tkw)
    ttrain = tdata.make_synthetic_dataset(n=48, n_classes=4, size=16, seed=0)
    tval = tdata.make_synthetic_dataset(n=16, n_classes=4, size=16, seed=1)
    tnet = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ttrain, device="cpu",
                 **common)
    tnet.model.load_state_dict(_torch_state(jtr))
    return jtr, NWTrainer(tnet, ttrain, tval, **tkw)


def _torch_state(jtr):
    return jax_to_torch_nwmodel(jax.tree_util.tree_map(
        np.asarray, {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))


def _assert_state_matches(ttr, jtr, before):
    """Every tensor of the port's state is within STEP_REL of the JAX
    step's size from JAX's."""
    want = _torch_state(jtr)
    got = ttr.net.model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            moved = float((v - before[k]).abs().max())
            err = float((got[k] - v).abs().max())
            assert err <= STEP_REL * moved + 1e-7, (k, err, moved)


@pytest.mark.parametrize("kernel,fused", [("euclidean", True), ("clip", False)])
def test_two_trainer_steps_match_jax(kernel, fused):
    jtr, ttr = _trainers(kernel, fused)
    before = {k: v.clone() for k, v in ttr.net.model.state_dict().items()}
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    assert ttr.step == jtr.state.step == 2
    np.testing.assert_allclose(ttr.metrics["loss:train"].result(),
                               jtr.metrics["loss:train"].result(), rtol=1e-4)
    _assert_state_matches(ttr, jtr, before)
    moved = ttr.net.model.state_dict()
    assert not torch.equal(moved["featurizer.layer4.0.bn2.running_var"],
                           before["featurizer.layer4.0.bn2.running_var"])
    # Eval in the random mode (episodes drawn from the bank) and the full
    # mode (prepared bank when fused): the same metrics. Before the forward
    # below, which updates the port's BatchNorm statistics in place.
    ttr.eval_all_modes(num_steps=2)
    jtr.eval_all_modes(num_steps=2)
    for k, m in ttr.val_metrics.items():
        np.testing.assert_allclose(m.result(), jtr.val_metrics[k].result(), rtol=2e-3,
                                   atol=1e-3, err_msg=k)
    # Log-probs of one fixed episode afterwards (train mode, like the step).
    ds = ttr.train_dataset
    x, y = ds.gather(np.arange(4)), ds.targets[:4]
    sidx = np.arange(4, 20)
    support = (ds.gather(sidx), ds.targets[sidx], None)
    assert ttr.net.model.head.takes_fused(torch.zeros(4, 512), torch.zeros(16, 512)) == fused
    got, isin = ttr.net.forward(x, y, support_data=support)
    want, jisin, _ = jtr.net.forward(jtr.state.variables(), jnp.asarray(x), y,
                                     support_data=support)
    np.testing.assert_array_equal(isin, jisin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_freeze_featurizer():
    """wd=0: the port matches JAX (only clip's scale trains; BatchNorm
    statistics still move). wd>0: no featurizer parameter moves in the port
    (JAX decays them, ROADMAP.md queue 3)."""
    jtr, ttr = _trainers("clip", False, freeze=True, wd=0.0)
    before = {k: v.clone() for k, v in ttr.net.model.state_dict().items()}
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    _assert_state_matches(ttr, jtr, before)

    _, ttr = _trainers("clip", False, freeze=True, wd=1e-2)
    before = {k: v.clone() for k, v in ttr.net.model.named_parameters()}
    ttr.train_epoch(num_steps=2)
    after = dict(ttr.net.model.named_parameters())
    for k, v in before.items():
        if k.startswith("featurizer."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["head.logit_scale"], before["head.logit_scale"])


def test_lr_schedule_crosses_milestone_at_optax_step():
    from nwhead_tpu.train import multistep_lr as jax_multistep_lr

    ours = multistep_lr(0.1, (2, 4), 0.1, 5)
    theirs = jax_multistep_lr(0.1, (2, 4), 0.1, 5)
    for step in range(26):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step
    # The trainer sets each step's rate from its step count: 12 steps per
    # epoch here, so step 12 (the 13th) is the first at lr * gamma.
    ds = tdata.make_synthetic_dataset(n=48, n_classes=4, size=8, seed=0)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ds, device="cpu")
    tr = NWTrainer(net, ds, ds, lr=0.1, batch_size=4, milestones=(1,), gamma=0.1)
    tr.train_epoch(num_steps=12)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(0.1)
    tr.train_epoch(num_steps=1)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(0.01)


CLI = ["--dataset", "synthetic", "--arch", "resnet10", "--batch_size", "4", "--n_way", "4",
       "--num_steps_per_epoch", "3", "--num_val_steps_per_epoch", "2"]


def test_cli_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.train", "--device", "cpu", *CLI,
         "--num_epochs", "1", "--models_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Train loss=" in proc.stdout and "acc:val:full=" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "nwhead_tpu_torch.train", *CLI, "--num_epochs", "1",
             "--models_dir", str(tmp_path)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("flags", [["--mesh", "2,2"], ["--bf16"], ["--train_method", "fchead"],
                                   ["--use_wandb"], ["--workers", "4"],
                                   ["--pretrained_path", "weights.npz"]])
def test_cli_refuses_what_is_not_ported(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_setup(["--device", "cpu", *CLI, "--models_dir", str(tmp_path), *flags])


def test_resume_equals_uninterrupted_run(tmp_path):
    common = ["--device", "cpu", *CLI, "--log_interval", "1"]
    control = train_main(common + ["--num_epochs", "2", "--models_dir", str(tmp_path / "a")])
    train_main(common + ["--num_epochs", "1", "--models_dir", str(tmp_path / "b")])
    resumed = train_main(common + ["--num_epochs", "2", "--resume",
                                   "--models_dir", str(tmp_path / "b")])
    assert resumed.step == control.step == 6
    want = control.net.model.state_dict()
    for k, v in resumed.net.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed.optimizer.state_dict()["state"].keys() == control.optimizer.state_dict()["state"].keys()


class _HostOnly:
    """A dataset with no in-memory ``images`` array: the trainer takes the
    host gather + prefetch path for it."""

    def __init__(self, ds):
        self._ds, self.targets, self.num_classes = ds, ds.targets, ds.num_classes

    def __len__(self):
        return len(self._ds)

    def gather(self, idx):
        return self._ds.gather(idx)


def test_host_pipeline_equals_device_resident_path():
    """The prefetching host path trains and evaluates exactly as the
    device-resident index path: the same episodes, the same weights after
    3 steps, the same eval metrics (tail batch padded)."""
    ds = tdata.make_synthetic_dataset(n=48, n_classes=4, size=8, seed=0)
    states = []
    for train in (ds, _HostOnly(ds)):
        assert (tpipe.device_images(train, "cpu") is None) == (train is not ds)
        net = NWNet(load_model("resnet10", device="cpu",
                               generator=torch.Generator().manual_seed(0)),
                    4, support_dataset=train, device="cpu", n_shot=2)
        tr = NWTrainer(net, train, ds, lr=0.05, batch_size=4)
        tr.train_epoch(num_steps=3)
        tr.val_dataset = tdata.make_synthetic_dataset(n=10, n_classes=4, size=8, seed=1)
        if train is not ds:
            tr.val_dataset = _HostOnly(tr.val_dataset)
        tr.eval_all_modes()
        metrics = {k: m.result() for k, m in tr.val_metrics.items()}
        states.append((tr.step_losses, net.model.state_dict(), metrics))
    assert states[0][0] == states[1][0] and states[0][2] == states[1][2]
    for k, v in states[0][1].items():
        assert torch.equal(v, states[1][1][k]), k


def test_batch_loader_matches_jax():
    from nwhead_tpu.data.pipeline import BatchLoader as JBatchLoader

    ds = tdata.make_synthetic_dataset(n=23, n_classes=4, size=4, seed=0)
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False, drop_last=False)):
        ours, theirs = tpipe.BatchLoader(ds, 5, **kw), JBatchLoader(ds, 5, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):  # a reshuffle per epoch
            for (xa, ya), (xb, yb) in zip(ours, theirs, strict=True):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)


def test_per_query_support_and_projection_match_jax():
    """``NWModel.forward`` with a per-query support ``(B, S, H, W, C)`` and a
    ``proj_dim`` projection carried across by ``jax_to_torch_nwmodel``: the
    same train-mode log-probs as JAX's (rtol=atol=1e-4)."""
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet

    jtrain = jsyn(n=24, n_classes=4, size=16, seed=0)
    jnet = JNWNet(jload("resnet10"), 4, support_dataset=jtrain, feat_dim=512, proj_dim=8,
                  kernel_type="cosine", seed=0)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(jtrain.gather(np.arange(2))))
    ds = tdata.make_synthetic_dataset(n=24, n_classes=4, size=16, seed=0)
    tnet = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ds, device="cpu",
                 feat_dim=512, proj_dim=8, kernel_type="cosine", seed=0)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(jax.tree_util.tree_map(np.asarray, variables)))
    x, y = ds.gather(np.arange(2)), ds.targets[:2]
    sidx = np.arange(2, 14).reshape(2, 6)
    sx, sy = ds.gather(sidx.ravel()).reshape(2, 6, 16, 16, 3), ds.targets[sidx]
    got, isin = tnet.forward(x, y, support_data=(sx, sy, None))
    want, jisin, _ = jnet.forward(variables, jnp.asarray(x), y, support_data=(sx, sy, None))
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(isin, jisin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
