"""The init-sample draw (JAX ``serve.py:76``, ``eval.py:134``,
``train/trainer.py:142``, ``:416``): the port draws and drops the same
``min(batch_size, len(train_ds))`` items at the same point, so a dataset
with the seeded random training transform gives the same crops and flips
afterwards as JAX's at the same seed, with no draw made by the test.

On CIFAR-10-shaped ``.npy`` files (64 / 32 images, 10 classes) with the
``cifar_train`` transform of seed 0:

* the serve CLI's ``build_server``: the same images drawn, in the same
  order (the init sample, then the bank's batches), equal bit for bit, and
  with JAX's weights carried across the bank's features within 1e-4 of
  max|JAX|;
* ``FCTrainer``: the init sample and the first step's batch, bit for bit;
* ``NWTrainer``: the init sample and the first episode's query and support
  images, bit for bit.
"""

import argparse

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_TRAIN, N_TEST, C = 64, 32, 10


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(11)
    base = root / "cifar10"
    base.mkdir()
    for split, n in (("train", N_TRAIN), ("test", N_TEST)):
        np.save(base / f"{split}_images.npy", rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        np.save(base / f"{split}_labels.npy", np.arange(n) % C)
    return root


def _recording(monkeypatch, cls, log):
    """Record every array ``cls.gather`` returns from a training-transform
    dataset."""
    gather = cls.gather

    def recording(self, idx):
        out = gather(self, idx)
        if getattr(self.transform, "kind", None) == "cifar_train":
            log.append(np.asarray(out).copy())
        return out

    monkeypatch.setattr(cls, "gather", recording)


def _assert_same_draws(got, want):
    assert len(got) == len(want) and len(got) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_build_server_bank_matches_jax(cifar_root, monkeypatch):
    """The serve CLI's bank: the init sample (8 images), then the bank's 50
    rows, drawn from the training transform as JAX's ``build_server`` draws
    them; the port's bank features, JAX's weights carried across, within
    1e-4 of max|JAX| (resnet10, f32 on both sides)."""
    import serve as jserve
    from nwhead_tpu.data.datasets import ArrayDataset as JArrayDataset
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.data.datasets import ArrayDataset
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel

    jax_log, port_log = [], []
    _recording(monkeypatch, JArrayDataset, jax_log)
    _recording(monkeypatch, ArrayDataset, port_log)
    jargs = argparse.Namespace(
        dataset="cifar10", data_dir=str(cifar_root), arch="resnet10", ckpt=None,
        pretrained_path=None, batch_size=8, kernel_type="euclidean", proj_dim=0,
        n_shot_full=5, bf16=False, head_precision="f32", featurizer_precision="f32",
        calib_images=16, fused_inference=False, workers=1, decoder="pil", seed=0,
        bank_cache=None, mesh=None, serve_mode="full", ivf_probe=32, ivf_group=None)
    jnet, variables, _, _ = jserve.build_server(jargs)

    pargs = pserve.parse_args([
        "--dataset", "cifar10", "--data_dir", str(cifar_root), "--arch", "resnet10",
        "--batch_size", "8", "--n_shot_full", "5", "--latency_bench", "--workers", "1",
        "--decoder", "pil", "--device", "cpu"])
    ptrain, pval = pserve.build_datasets(pargs)
    state = jax_to_torch_nwmodel(variables)
    pnet = pserve.build_server(pargs, ptrain, edit=lambda net: net.model.load_state_dict(state),
                               val_ds=pval)
    assert port_log[0].shape[0] == 8
    _assert_same_draws(port_log, jax_log)
    want = np.asarray(jnet.full_feat)
    got = pnet.full_feat.numpy()
    assert got.shape == want.shape == (50, 512)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"build_server bank vs JAX: {err:.2e} of max|JAX|")
    assert err <= 1e-4


def _cifar_sets(root, jax_side: bool):
    """The training CLI's CIFAR-10 sets (seeded ``cifar_train`` transform,
    seed 0) of the JAX package or of the port."""
    if jax_side:
        import train as jtrain

        return jtrain.build_datasets(argparse.Namespace(
            dataset="cifar10", data_dir=str(root), seed=0, workers=1, decoder="pil"))
    from nwhead_tpu_torch.train import build_datasets

    return build_datasets(argparse.Namespace(
        dataset="cifar10", data_dir=str(root), seed=0, workers=1, decoder="pil"))


def test_fc_trainer_first_batch_matches_jax(cifar_root, monkeypatch):
    """``FCTrainer`` (batch 8, seed 0): the init sample, then the first
    step's batch, equal to JAX's bit for bit (JAX's step is not run)."""
    import jax.numpy as jnp

    from nwhead_tpu.data.datasets import ArrayDataset as JArrayDataset
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.fc import FCNet as JFCNet
    from nwhead_tpu.train import FCTrainer as JFCTrainer
    from nwhead_tpu_torch.data.datasets import ArrayDataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.fc import FCNet
    from nwhead_tpu_torch.train.trainer import FCTrainer

    jax_log, port_log = [], []
    _recording(monkeypatch, JArrayDataset, jax_log)
    _recording(monkeypatch, ArrayDataset, port_log)
    jtrain, jval = _cifar_sets(cifar_root, jax_side=True)
    jtr = JFCTrainer(JFCNet(featurizer=jload("resnet10"), num_classes=C), jtrain, jval,
                     batch_size=8, seed=0)
    jtr._train_step = lambda p, b, o, img, label: (p, b, o, jnp.float32(0), jnp.float32(0))
    jtr.train_epoch(num_steps=1)

    ptrain, pval = _cifar_sets(cifar_root, jax_side=False)
    ptr = FCTrainer(FCNet(load_model("resnet10", device="cpu"), C), ptrain, pval,
                    batch_size=8, seed=0)
    ptr.train_epoch(num_steps=1)
    assert len(port_log) == 2 and port_log[1].shape == (8, 32, 32, 3)
    _assert_same_draws(port_log, jax_log)


def test_nw_trainer_first_episode_matches_jax(cifar_root, monkeypatch):
    """``NWTrainer`` (batch 4, 4-way 1-shot episodes, seed 0): the init
    sample, then the first episode's query and support images, equal to
    JAX's bit for bit (the draws are recorded; JAX's step is not run)."""
    from nwhead_tpu.data.datasets import ArrayDataset as JArrayDataset
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.train import NWTrainer as JNWTrainer
    from nwhead_tpu_torch.data.datasets import ArrayDataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.train.trainer import NWTrainer

    common = dict(n_way=4, n_shot=1, seed=0)
    jax_log, port_log = [], []
    _recording(monkeypatch, JArrayDataset, jax_log)
    _recording(monkeypatch, ArrayDataset, port_log)
    jtrain, jval = _cifar_sets(cifar_root, jax_side=True)
    jtr = JNWTrainer(JNWNet(jload("resnet10"), C, support_dataset=jtrain, feat_dim=512,
                            **common), jtrain, jval, batch_size=4, seed=0)
    n_init = len(jax_log)

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    jtr._train_step = stop  # the first batch is drawn, the step is not run
    with pytest.raises(Stop):
        jtr.train_epoch(num_steps=1)

    ptrain, pval = _cifar_sets(cifar_root, jax_side=False)
    ptr = NWTrainer(NWNet(load_model("resnet10", device="cpu"), C, support_dataset=ptrain,
                          device="cpu", feat_dim=512, **common), ptrain, pval, batch_size=4, seed=0)
    assert len(port_log) == n_init == 1
    ptr.train_step = lambda *a: (_ for _ in ()).throw(Stop())
    with pytest.raises(Stop):
        ptr.train_epoch(num_steps=1)
    assert len(port_log) == len(jax_log) >= 3
    _assert_same_draws(port_log, jax_log)
