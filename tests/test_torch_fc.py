"""The FC baseline of the port against the JAX package's.

* ``FCNet`` log-probs, eval and train mode, on weights carried across by
  ``jax_to_torch_fcnet``: ResNet-10 at 16 px (rtol=atol=1e-4, as the NW
  forward in ``tests/test_torch_train_slice.py``).
* The classifier's init: uniform within +-1/sqrt(fan_in), JAX's bound, from
  the generator it is given.
* Two ``FCTrainer`` steps from the same weights on the same batches of 8
  (at 4, the last blocks' BatchNorm normalizes 4 values a channel and the
  two featurizers' rounding moves the step by up to 17%): the mean loss
  at rtol=1e-4 and every parameter and BatchNorm statistic
  within 1% of how far the JAX step moved it (the tolerance of
  ``tests/test_torch_train_slice.py``: the two f32 featurizers differ by
  up to 1e-3 relative), then eval within rtol 2e-3.
* ``eval_epoch`` pads the tail batch and drops the padding, as JAX's.
* ``freeze_featurizer``: with wd=0 it matches JAX; with wd>0 the port's
  featurizer does not move at all (JAX's optimizer still decays it,
  ROADMAP.md queue 3).
* The training CLI's ``--train_method fchead`` on CIFAR ``.npy`` files:
  an epoch, its checkpoint (no sampler sidecar), and a resume whose epoch
  gathers the indices JAX's resumed run gathers (a fresh generator's
  permutation, as JAX's CLI does not restore it).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu_torch import train as train_cli
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_fcnet
from nwhead_tpu_torch.nw.fc import FCHead, FCNet
from nwhead_tpu_torch.train.checkpoint import latest_checkpoint
from nwhead_tpu_torch.train.trainer import FCTrainer

torch.set_num_threads(1)

STEP_REL = 1e-2  # of the JAX update's size, per tensor
SIZE = 16


@pytest.fixture(autouse=True)
def jitted_jax_init(monkeypatch):
    """JAX's ``FCTrainer`` initializes its net eagerly, about 14 s of
    op-by-op compiles on the CPU; here one jitted init per net config
    (other random weights than the eager init's; the port gets whatever
    JAX's trainer holds)."""
    import flax.linen as nn

    from nwhead_tpu.nw.fc import FCNet as JFCNet

    eager = nn.Module.init

    def init(self, key, x, train=True, **kw):
        if kw:
            return eager(self, key, x, train=train, **kw)
        return _JIT_INIT(self, key, x, train)

    monkeypatch.setattr(JFCNet, "init", init)


def _init_fn(module, key, x, train):
    import flax.linen as nn

    return nn.Module.init(module, key, x, train=train)


_JIT_INIT = jax.jit(_init_fn, static_argnums=(0, 3))


def _data(n, seed):
    return tdata.make_synthetic_dataset(n=n, n_classes=4, size=SIZE, seed=seed)


def _jax_data(n, seed):
    from nwhead_tpu.data.datasets import make_synthetic_dataset

    return make_synthetic_dataset(n=n, n_classes=4, size=SIZE, seed=seed)


def _torch_state(variables):
    return jax_to_torch_fcnet(jax.tree_util.tree_map(np.asarray, variables))


def _port_net(variables):
    net = FCNet(load_model("resnet10", device="cpu"), 4)
    net.load_state_dict(_torch_state(variables))
    return net


def test_fcnet_log_probs_match_jax():
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.fc import FCNet as JFCNet

    x = _data(6, 0).gather(np.arange(6))
    jnet = JFCNet(featurizer=jload("resnet10"), num_classes=4)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    net = _port_net(variables)
    assert net.classifier.fc.weight.shape == (4, 512)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
        feat = net.extract_feat(torch.from_numpy(x))
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want = jax.jit(lambda v, x: jnet.apply(v, x, method=JFCNet.extract_feat))(variables, x)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    net.train()
    got = net(torch.from_numpy(x))
    want, _ = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(torch.exp(got).sum(-1).detach().numpy(), 1.0, rtol=1e-5)


def test_classifier_init_bounds():
    from nwhead_tpu.nw.fc import torch_linear_bias_init, torch_linear_kernel_init

    bound = 1.0 / np.sqrt(512)
    heads = [FCHead(512, 100, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    for h in heads:
        for t in (h.fc.weight.detach(), h.fc.bias.detach()):
            assert float(t.abs().max()) <= bound
        w = h.fc.weight.detach()
        assert float(w.abs().max()) > 0.99 * bound
        # uniform: the variance of U(-b, b) is b^2 / 3
        assert abs(float(w.var()) / (bound ** 2 / 3) - 1) < 0.05
    assert torch.equal(heads[0].fc.weight, heads[1].fc.weight)
    assert not torch.equal(heads[0].fc.weight, heads[2].fc.weight)
    kernel = np.asarray(torch_linear_kernel_init(jax.random.PRNGKey(0), (512, 100)))
    bias = np.asarray(torch_linear_bias_init(512)(jax.random.PRNGKey(1), (100,)))
    assert np.abs(kernel).max() <= bound and np.abs(bias).max() <= bound
    assert np.abs(kernel).max() > 0.99 * bound
    net = FCNet(load_model("resnet10", device="cpu"), 7,
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(net.classifier.fc.weight, FCHead(
        512, 7, generator=torch.Generator().manual_seed(0)).fc.weight)


def _trainers(*, freeze=False, wd=1e-4, n_val=16):
    """A JAX and a port FC trainer on the same data and weights."""
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.fc import FCNet as JFCNet
    from nwhead_tpu.train import FCTrainer as JFCTrainer

    kw = dict(lr=0.05, batch_size=8, milestones=(100,), weight_decay=wd,
              freeze_featurizer=freeze, seed=0)
    jtr = JFCTrainer(JFCNet(featurizer=jload("resnet10"), num_classes=4), _jax_data(48, 0),
                     _jax_data(n_val, 1), **kw)
    net = _port_net({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})
    return jtr, FCTrainer(net, _data(48, 0), _data(n_val, 1), **kw)


def _assert_state_matches(ttr, jtr, before):
    want = _torch_state({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})
    got = ttr.model.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        moved = float((v - before[k]).abs().max())
        err = float((got[k] - v).abs().max())
        assert err <= STEP_REL * moved + 1e-7, (k, err, moved)


def test_two_fc_trainer_steps_match_jax():
    jtr, ttr = _trainers()
    before = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    assert ttr.step == jtr.state.step == 2 and ttr.steps_per_epoch == jtr.steps_per_epoch == 6
    for k in ("loss:train", "acc:train"):
        np.testing.assert_allclose(ttr.metrics[k].result(), jtr.metrics[k].result(), rtol=1e-4)
    assert len(ttr.step_losses) == 2
    _assert_state_matches(ttr, jtr, before)
    assert not torch.equal(ttr.model.state_dict()["featurizer.layer4.0.bn2.running_var"],
                           before["featurizer.layer4.0.bn2.running_var"])
    acc = ttr.eval_epoch()
    assert acc == jtr.eval_epoch()
    for k, m in ttr.val_metrics.items():
        np.testing.assert_allclose(m.result(), jtr.val_metrics[k].result(), rtol=2e-3,
                                   atol=1e-3, err_msg=k)
    assert ttr.lr_schedule(ttr.step) == pytest.approx(float(jtr.lr_schedule(jtr.state.step)))


def test_eval_epoch_pads_the_tail_as_jax():
    """10 validation images in batches of 8: the last batch holds 2 real
    rows; the metrics count those only, as JAX's, and equal one unpadded
    pass over the 10."""
    jtr, ttr = _trainers(n_val=10)
    acc = ttr.eval_epoch()
    assert acc == jtr.eval_epoch()
    for k, m in ttr.val_metrics.items():
        np.testing.assert_allclose(m.result(), jtr.val_metrics[k].result(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    with torch.no_grad():
        out = ttr.model.eval()(torch.from_numpy(ttr.val_dataset.gather(np.arange(10))))
    y = torch.from_numpy(ttr.val_dataset.targets)
    assert acc == pytest.approx(float((out.argmax(-1) == y).float().mean()) * 100)
    np.testing.assert_allclose(ttr.val_metrics["loss:val"].result(),
                               float(torch.nn.functional.nll_loss(out, y)), rtol=1e-5)
    ttr.reset_metrics()
    ttr.eval_epoch(num_steps=1)
    assert ttr.val_metrics["acc:val"].num_samples == 8


def test_freeze_featurizer():
    """wd=0: the port matches JAX (the classifier trains, BatchNorm
    statistics still move). wd>0: no featurizer parameter moves in the
    port."""
    jtr, ttr = _trainers(freeze=True, wd=0.0)
    before = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    _assert_state_matches(ttr, jtr, before)

    ttr = FCTrainer(FCNet(load_model("resnet10", device="cpu"), 4), _data(48, 0), _data(8, 1),
                    lr=0.05, batch_size=8, weight_decay=1e-2, freeze_featurizer=True)
    before = {k: v.clone() for k, v in ttr.model.named_parameters()}
    ttr.train_epoch(num_steps=2)
    after = dict(ttr.model.named_parameters())
    for k, v in before.items():
        if k.startswith("featurizer."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["classifier.fc.weight"], before["classifier.fc.weight"])


def _write_cifar(data_dir, n_train=22, n_test=6):
    rng = np.random.default_rng(0)
    base = os.path.join(data_dir, "cifar10")
    os.makedirs(base)
    for split, n in (("train", n_train), ("test", n_test)):
        np.save(os.path.join(base, f"{split}_images.npy"),
                rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        np.save(os.path.join(base, f"{split}_labels.npy"), rng.integers(0, 10, n))


def test_fchead_cli_epoch_checkpoint_and_resume(tmp_path, monkeypatch):
    from nwhead_tpu.data.datasets import ArrayDataset as JArrayDataset
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.fc import FCNet as JFCNet
    from nwhead_tpu.train import FCTrainer as JFCTrainer

    _write_cifar(str(tmp_path))
    argv = ["--device", "cpu", "--dataset", "cifar10", "--data_dir", str(tmp_path),
            "--arch", "resnet10", "--train_method", "fchead", "--batch_size", "4",
            "--num_steps_per_epoch", "3", "--log_interval", "1", "--seed", "2",
            "--models_dir", str(tmp_path / "runs")]
    first = train_cli.main(argv + ["--num_epochs", "1"])
    assert isinstance(first, FCTrainer) and first.step == 3
    path = latest_checkpoint(os.path.join(
        str(tmp_path / "runs"), os.listdir(str(tmp_path / "runs"))[0], "checkpoints"))
    assert path.endswith("model.0001") and not os.path.exists(path + ".sampler.json")

    drawn = []
    gather = tdata.ArrayDataset.gather

    def recording(self, idx):
        if self.transform is not None and self.transform.kind == "cifar_train":
            drawn.append(np.asarray(idx).tolist())
        return gather(self, idx)

    monkeypatch.setattr(tdata.ArrayDataset, "gather", recording)
    resumed = train_cli.main(argv + ["--num_epochs", "2", "--resume"])
    assert resumed.step == 6
    assert all(torch.isfinite(torch.tensor(resumed.step_losses)))

    # JAX's resumed run: a new trainer, its generator fresh from the seed.
    x = np.load(tmp_path / "cifar10" / "train_images.npy")
    y = np.load(tmp_path / "cifar10" / "train_labels.npy")
    jax_drawn = []

    class Recording(JArrayDataset):
        def gather(self, idx):
            jax_drawn.append(np.asarray(idx).tolist())
            return super().gather(idx)

    jds = Recording(x.astype(np.float32), y, 10)
    # Both trainers draw the init sample first (JAX's for net.init), then
    # the three steps' batches.
    jtr = JFCTrainer(JFCNet(featurizer=jload("resnet10"), num_classes=10), jds, jds,
                     batch_size=4, seed=2)
    jtr._train_step = lambda p, b, o, img, label: (p, b, o, jnp.float32(0), jnp.float32(0))
    jtr.train_epoch(num_steps=3)
    assert drawn == jax_drawn and len(drawn) == 4
