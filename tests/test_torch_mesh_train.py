"""The mesh's training half of the port against the JAX package's
``tests/test_parallel.py`` and ``tests/test_cli_surface.py`` mesh cases, on
the CPU: JAX's meshes over the eight virtual devices of
``tests/conftest.py``, the port's over ``[torch.device("cpu")] * n``, inputs
from numpy seeds, JAX's weights carried into the port.

* One data-parallel step on mesh (8, 1) with JAX's ``Tiny`` featurizer
  (a 3x3 conv, BatchNorm, ReLU, the spatial mean, a 16-wide Dense): the
  port's ``NWTrainer(mesh=)`` step against JAX's jitted step over a
  data-sharded batch (loss rtol 1e-4, parameters and running statistics
  within 1% of how far JAX's step moved them) and against the port's
  meshless step (1e-5: the same function, other summation orders).
* Sync BatchNorm (``bn_axis_name="data"``) on ``CIFAR_ResNet10`` over
  eight replicas against full-batch BatchNorm: JAX's full-batch forward at
  JAX's rtol=atol=5e-3 and its running statistics at the zoo's 1e-3 /
  1e-4; the port's full-batch forward at 1e-4; the gradients within 2e-2
  of each tensor's largest entry of the full batch in f64 (measured
  7.9e-3; the f32 full batch itself is 3.3e-2 from f64 at these weights).
  bf16: held as ``tests/test_torch_zoo_train.py`` holds a bf16 train-mode
  forward, to ``BF16_NOISE`` times what bf16 moves JAX's own result.
* ``NWTrainer(mesh=)`` end to end on mesh (4, 2): per-step losses against
  JAX's mesh trainer (rtol 1e-4), parameters and running statistics within
  1% of JAX's move after three steps, full-mode eval through
  ``net.sharded_bank`` with JAX's metrics (rtol 2e-3).
* Distributed precompute on mesh (4, 2) against the meshless port (1e-5)
  and JAX's bank features (1e-4).
* The model axis: the column-parallel Dense on mesh (2, 2, 2) against the
  unsharded product and JAX's sharded one (1e-4); ``make_mesh``'s axes as
  JAX resolves them.
* ``train --device cpu --mesh 2,2`` and the eval CLI over its checkpoint
  (full, knn, ensemble; one environment's ensemble equals full), resume
  under ``--mesh`` bit for bit, ``--train_method fchead --mesh`` refused
  with JAX's message, a batch that does not split over the data axis with
  JAX's assertion.
* ``replicate``'s copy path (a replica on another device, forced on the
  CPU): the model's outputs, gradients and one update of its running
  statistics, bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_featurizer
from nwhead_tpu_torch.models.resnet import BatchNorm2d
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.parallel.data_parallel import data_parallel
from nwhead_tpu_torch.parallel.mesh import column_parallel_dense, make_mesh
from nwhead_tpu_torch.train import main as train_main
from nwhead_tpu_torch.train import setup as train_setup
from nwhead_tpu_torch.train.trainer import NWTrainer
from test_torch_zoo import _jax_fns, _pair, _x
from test_torch_zoo_train import BF16_NOISE, BF16_REL, STATS_TOL, _stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEP_REL = 1e-2  # of the JAX update's size, per tensor
CLI = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10", "--batch_size", "4",
       "--n_way", "4", "--n_shot", "1", "--num_steps_per_epoch", "2",
       "--num_val_steps_per_epoch", "1", "--log_interval", "1"]


class Tiny(nn.Module):
    """JAX ``test_parallel``'s ``Tiny`` in the port: NHWC in, a SAME 3x3
    conv to 8 channels, the port's BatchNorm (the one that syncs over data
    replicas), ReLU, the spatial mean, a Dense to 16."""

    feat_dim = 16

    def __init__(self) -> None:
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = BatchNorm2d(8, eps=1e-5)
        self.dense = nn.Linear(8, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.dense(h.mean(dim=(2, 3)))


def _jax_tiny():
    import flax.linen as fnn

    class JTiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = True):
            x = fnn.Conv(8, (3, 3), padding="SAME")(x)
            x = fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
            x = fnn.relu(x)
            x = jnp.mean(x, axis=(1, 2))
            return fnn.Dense(16)(x)

    return JTiny()


def _tiny_state(variables) -> dict:
    """A JAX ``NWModel(Tiny)`` tree -> the port ``NWModel``'s state dict."""
    p, s = variables["params"]["featurizer"], variables["batch_stats"]["featurizer"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return {"featurizer.conv.weight": t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1),
            "featurizer.conv.bias": t(p["Conv_0"]["bias"]),
            "featurizer.bn.weight": t(p["BatchNorm_0"]["scale"]),
            "featurizer.bn.bias": t(p["BatchNorm_0"]["bias"]),
            "featurizer.bn.running_mean": t(s["BatchNorm_0"]["mean"]),
            "featurizer.bn.running_var": t(s["BatchNorm_0"]["var"]),
            "featurizer.bn.num_batches_tracked": torch.tensor(0),
            "featurizer.dense.weight": t(p["Dense_0"]["kernel"]).T,
            "featurizer.dense.bias": t(p["Dense_0"]["bias"])}


def _state_matches(got: dict, want: dict, before: dict, rel: float) -> None:
    """Every float tensor of ``got`` within ``rel`` of how far the
    reference step moved it from ``before`` (flax keeps no batch count)."""
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        moved = float((v - before[k]).abs().max())
        err = float((got[k] - v).abs().max())
        assert err <= rel * moved + 1e-7, (k, err, moved)


def _port_trainer(mesh, ds, lr):
    net = NWNet(Tiny(), 4, support_dataset=ds, device="cpu", feat_dim=16, n_shot=1, seed=0,
                mesh=mesh)
    return NWTrainer(net, ds, ds, lr=lr, batch_size=16, milestones=(100,), weight_decay=0.0,
                     eval_modes=("full",), seed=0, mesh=mesh)


def test_data_parallel_step_matches_jax_and_meshless():
    """``tests/test_parallel.py:208``: one SGD step (lr 0.1, nesterov) on a
    B=16 batch sharded over 8 devices, S=8 support rows replicated."""
    import optax

    from nwhead_tpu.nw.net import NWModel as JNWModel
    from nwhead_tpu.parallel import make_mesh as jmake_mesh

    rng = np.random.default_rng(0)
    B, S = 16, 8
    qimg = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    simg = rng.standard_normal((S, 8, 8, 3)).astype(np.float32)
    sy = rng.integers(0, 4, size=S).astype(np.int32)
    qy = rng.integers(0, 4, size=B).astype(np.int32)

    jmesh = jmake_mesh(8, 1)
    model = JNWModel(featurizer=_jax_tiny(), n_classes=4)
    variables = jax.jit(lambda k, q, s, y: model.init(k, q, s, y, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(qimg), jnp.asarray(simg), jnp.asarray(sy))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)

    @jax.jit
    def step(params, batch_stats, qimg, qy, simg, sy):
        def loss_fn(p):
            lp, upd = model.apply({"params": p, "batch_stats": batch_stats}, qimg, simg, sy,
                                  train=True, mutable=["batch_stats"])
            return -jnp.mean(jnp.take_along_axis(lp, qy[:, None], axis=-1)), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), new_stats, loss

    shard, repl = NamedSharding(jmesh, P("data")), NamedSharding(jmesh, P())
    new_params, new_stats, jloss = step(
        variables["params"], variables["batch_stats"], jax.device_put(qimg, shard),
        jax.device_put(qy, shard), jax.device_put(simg, repl), jax.device_put(sy, repl))
    want = _tiny_state(jax.tree_util.tree_map(
        np.asarray, {"params": new_params, "batch_stats": new_stats}))
    before = _tiny_state(variables)

    ds = make_synthetic_dataset(n=16, n_classes=4, size=8, seed=0)
    losses, states = [], []
    for mesh in (make_mesh(8, 1, devices=[CPU] * 8), None):
        trainer = _port_trainer(mesh, ds, lr=0.1)
        trainer.net.model.load_state_dict(before)
        loss, _ = trainer.train_step(torch.from_numpy(qimg), torch.from_numpy(qy).long(),
                                     torch.from_numpy(simg), torch.from_numpy(sy).long())
        losses.append(float(loss))
        states.append({k: v.clone() for k, v in trainer.net.model.state_dict().items()})
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-4)
    _state_matches(states[0], want, before, STEP_REL)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for k, v in states[1].items():
        np.testing.assert_allclose(states[0][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _full_batch_grads(net, x, dtype):
    out = net.to(dtype).train()(x.to(dtype))
    return torch.autograd.grad(out.to(dtype).square().sum(), list(net.parameters()))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sync_batchnorm_matches_full_batch(bf16):
    """``tests/test_parallel.py:589``: eight replicas, each two images, with
    ``bn_axis_name="data"``, equal one full-batch BatchNorm of 16."""
    import copy

    x = _x((16, 32, 32, 3), seed=2)
    variables, full, _, fwd_train = _pair("CIFAR_ResNet10", x[:1], bf16=bf16)
    want, updated = fwd_train(variables, jnp.asarray(x))
    want = np.asarray(want, np.float32)
    sync = load_model("CIFAR_ResNet10", device="cpu", bn_axis_name="data",
                      dtype=torch.bfloat16 if bf16 else None)
    sync.load_state_dict(jax_to_torch_featurizer(variables))
    ref64 = copy.deepcopy(sync).double()
    assert all(m.axis_name == "data" for m in sync.modules() if isinstance(m, BatchNorm2d))
    devices = list(make_mesh(8, 1, devices=[CPU] * 8).devices[:, 0, 0])
    xt = torch.from_numpy(x)
    got = torch.cat(data_parallel(sync.train(), list(xt.chunk(8)), devices))
    full.train()
    port_full = full(xt)
    want_sd = jax_to_torch_featurizer({"params": variables["params"], "batch_stats":
                                       jax.tree_util.tree_map(np.asarray, updated["batch_stats"])})
    if not bf16:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got.detach().numpy(), port_full.detach().numpy(), rtol=1e-4,
                                   atol=1e-4)
        for k, v in _stats(sync).items():
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), **STATS_TOL, err_msg=k)
        grads = torch.autograd.grad(got.square().sum(), list(sync.parameters()))
        want64 = _full_batch_grads(ref64, xt, torch.float64)
        for (name, _), g, w in zip(sync.named_parameters(), grads, want64):
            err = float((g.double() - w).abs().max() / w.abs().max())
            assert err <= 2e-2, (name, err)
        return
    want32, updated32 = _jax_fns("CIFAR_ResNet10")[2](variables, jnp.asarray(x))
    noise = np.abs(want - np.asarray(want32)).max()
    for out in (got, port_full):
        err = np.abs(out.detach().float().numpy() - want).max()
        assert err <= BF16_NOISE * noise + BF16_REL * np.abs(want).max() * 0.1, (err, noise)
    sd32 = jax_to_torch_featurizer({"params": variables["params"], "batch_stats":
                                    jax.tree_util.tree_map(np.asarray, updated32["batch_stats"])})
    for k, v in _stats(sync).items():
        err, noise = float((v - want_sd[k]).abs().max()), float((want_sd[k] - sd32[k]).abs().max())
        assert err <= BF16_NOISE * noise + 1e-3 * float(want_sd[k].abs().max()), (k, err, noise)
    grads = torch.autograd.grad(got.float().square().sum(), list(sync.parameters()))
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32 for g in grads)


def test_mesh_trainer_matches_jax_end_to_end():
    """``tests/test_parallel.py:617``: ``NWTrainer(mesh=)`` on mesh (4, 2),
    three steps of B=4 (one query a data replica), then full mode over the
    support-sharded bank."""
    from nwhead_tpu.data import make_synthetic_dataset as jsynthetic
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.parallel import make_mesh as jmake_mesh
    from nwhead_tpu.train import NWTrainer as JNWTrainer

    jmesh = jmake_mesh(4, 2)
    jtrain, jval = jsynthetic(n=48, n_classes=4, size=8, seed=0), jsynthetic(
        n=16, n_classes=4, size=8, seed=1)
    common = dict(feat_dim=16, n_shot=1, n_way=4, n_shot_full=5, seed=0)
    tkw = dict(lr=0.05, batch_size=4, milestones=(100,), eval_modes=("full",), seed=0)
    jnet = JNWNet(_jax_tiny(), n_classes=4, support_dataset=jtrain, mesh=jmesh, **common)
    jtr = JNWTrainer(jnet, jtrain, jval, mesh=jmesh, **tkw)

    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    ttrain = make_synthetic_dataset(n=48, n_classes=4, size=8, seed=0)
    tval = make_synthetic_dataset(n=16, n_classes=4, size=8, seed=1)
    tnet = NWNet(Tiny(), 4, support_dataset=ttrain, device="cpu", mesh=mesh, **common)
    ttr = NWTrainer(tnet, ttrain, tval, mesh=mesh, **tkw)
    state = lambda t: _tiny_state(jax.tree_util.tree_map(  # noqa: E731
        np.asarray, {"params": t.state.params, "batch_stats": t.state.batch_stats}))
    before = state(jtr)
    tnet.model.load_state_dict(before)
    for _ in range(3):
        ttr.train_epoch(num_steps=1)
        jtr.train_epoch(num_steps=1)
        np.testing.assert_allclose(ttr.metrics["loss:train"].result(),
                                   jtr.metrics["loss:train"].result(), rtol=1e-4)
        ttr.reset_metrics()
        jtr.reset_metrics()
    assert ttr.step == jtr.state.step == 3
    _state_matches(tnet.model.state_dict(), state(jtr), before, STEP_REL)
    ttr.eval_all_modes()
    jtr.eval_all_modes()
    assert tnet.sharded_bank is not None and tnet._prepared_full is None
    for k, m in ttr.val_metrics.items():
        np.testing.assert_allclose(m.result(), jtr.val_metrics[k].result(), rtol=2e-3,
                                   atol=1e-3, err_msg=k)


def test_distributed_precompute_matches():
    """``tests/test_parallel.py:654``: with a mesh (4, 2), each 16-image
    bank batch splits over the 8 devices (two images each)."""
    from nwhead_tpu.data import make_synthetic_dataset as jsynthetic
    from nwhead_tpu.nw.net import NWNet as JNWNet

    ds = jsynthetic(n=40, n_classes=4, size=8, seed=0)
    jnet = JNWNet(_jax_tiny(), n_classes=4, support_dataset=ds, feat_dim=16, n_shot=1,
                  n_shot_full=5, seed=0, precompute_batch=16)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(ds.gather(np.arange(2))))
    jnet.precompute(variables)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(5)  # BN statistics off (0, 1): a non-trivial eval pass
    stats = variables["batch_stats"]["featurizer"]["BatchNorm_0"]
    stats["mean"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    jnet.precompute(variables)

    feats = []
    for mesh in (make_mesh(4, 2, devices=[CPU] * 8), None):
        net = NWNet(Tiny(), 4, support_dataset=make_synthetic_dataset(
            n=40, n_classes=4, size=8, seed=0), device="cpu", feat_dim=16, n_shot=1,
            n_shot_full=5, seed=0, mesh=mesh, precompute_batch=16)
        net.model.load_state_dict(_tiny_state(variables))
        rows = []
        hook = net.model.featurizer.register_forward_hook(
            lambda m, i, o: rows.append(i[0].shape[0]))
        net.precompute()
        hook.remove()
        assert set(rows) == ({2} if mesh is not None else {16})
        feats.append(net.full_feat.numpy())
    np.testing.assert_allclose(feats[0], feats[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feats[0], np.asarray(jnet.full_feat), rtol=1e-4, atol=1e-4)


def test_model_axis_column_parallel_dense():
    """``tests/test_parallel.py:685``: the Dense kernel's columns over
    ``model``, the batch over ``data``; each device holds a column slice."""
    from nwhead_tpu.parallel import make_mesh as jmake_mesh, model_sharding as jmodel_sharding
    from nwhead_tpu_torch.parallel.mesh import model_sharding

    rng = np.random.default_rng(0)
    B, D_in, D_out = 8, 32, 64
    x = rng.standard_normal((B, D_in)).astype(np.float32)
    w = rng.standard_normal((D_in, D_out)).astype(np.float32)
    mesh = make_mesh(2, 2, n_model=2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "support": 2, "model": 2}
    pieces = model_sharding(mesh, torch.from_numpy(w))
    assert len(pieces) == 8 and all(tuple(p.shape) == (D_in, D_out // 2) for p in pieces)
    got = column_parallel_dense(mesh, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)

    jmesh = jmake_mesh(2, 2, n_model=2)
    want = jax.jit(lambda a, b: a @ b)(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("data"))),
        jax.device_put(jnp.asarray(w), jmodel_sharding(jmesh)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dims", [dict(n_data=4, n_support=2), dict(), dict(n_support=2),
                                  dict(n_data=2, n_model=2), dict(n_model=4)])
def test_make_mesh_axes_match_jax(dims):
    """``tests/test_parallel.py:705``: the model axis defaults to 1 and the
    missing axes resolve as JAX resolves them over 8 devices; each sharding
    helper places its pieces as JAX's ``NamedSharding`` does."""
    from nwhead_tpu.parallel import make_mesh as jmake_mesh
    from nwhead_tpu.parallel import mesh as jmesh_mod
    from nwhead_tpu_torch.parallel import mesh as tmesh_mod

    jmesh = jmake_mesh(**dims)
    mesh = make_mesh(devices=[CPU] * 8, **dims)
    assert mesh.shape == dict(jmesh.shape)
    t = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for name in ("data_sharding", "support_sharding", "replicated", "model_sharding"):
        arr = jax.device_put(jnp.asarray(t), getattr(jmesh_mod, name)(jmesh))
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        want = [by_device[d] for d in jmesh.devices.flat]
        got = getattr(tmesh_mod, name)(mesh, torch.from_numpy(t))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_cli_mesh_train_then_eval(tmp_path):
    """``tests/test_cli_surface.py:165`` and ``:181``: ``train --mesh 2,2``
    writes a checkpoint; the eval CLI over it with ``--mesh 2,2`` runs the
    sharded full, knn and ensemble modes, one environment's ensemble equal
    to full."""
    train_main([*CLI, "--mesh", "2,2", "--num_epochs", "1", "--models_dir",
                str(tmp_path / "runs")])
    run_dir = next(p for p in (tmp_path / "runs").iterdir() if p.is_dir())
    ckpt = run_dir / "checkpoints" / "model.0001"
    assert ckpt.exists()
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.eval", "--device", "cpu", "--dataset",
         "synthetic", "--arch", "resnet10", "--mesh", "2,2", "--modes", "full", "knn",
         "ensemble", "--batch_size", "4", "--num_val_steps", "2", "--ckpt", str(ckpt)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mode in ("full", "knn", "ensemble"):
        assert np.isfinite(out[mode]["acc"]) and 0 <= out[mode]["acc"] <= 100
    assert abs(out["ensemble"]["nll"] - out["full"]["nll"]) < 1e-5


def test_mesh_resume_equals_uninterrupted_run(tmp_path):
    """``--resume`` under ``--mesh 2,2`` continues bit for bit, and the
    checkpoint is the meshless trainer's."""
    common = [*CLI, "--mesh", "2,2"]
    control = train_main(common + ["--num_epochs", "2", "--models_dir", str(tmp_path / "a")])
    train_main(common + ["--num_epochs", "1", "--models_dir", str(tmp_path / "b")])
    resumed = train_main(common + ["--num_epochs", "2", "--resume", "--models_dir",
                                   str(tmp_path / "b")])
    assert resumed.step == control.step == 4
    want = control.net.model.state_dict()
    for k, v in resumed.net.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    meshless = train_setup([a for a in CLI] + ["--models_dir", str(tmp_path / "c")])[1]
    assert meshless.state_dict().keys() == resumed.state_dict().keys()
    assert meshless.state_dict()["model"].keys() == want.keys()


def test_fchead_mesh_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="--mesh supports --train_method nwhead only"):
        train_setup([*CLI, "--mesh", "2,2", "--train_method", "fchead", "--models_dir",
                     str(tmp_path)])


def test_batch_size_must_divide_the_data_axis():
    """JAX's assertion (``train/trainer.py:132``), and the mesh step's
    refusals: a BatchNorm that cannot sync, a checkpointed model."""
    ds = make_synthetic_dataset(n=16, n_classes=4, size=8, seed=0)
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    net = NWNet(Tiny(), 4, support_dataset=ds, device="cpu", n_shot=1, mesh=mesh)
    with pytest.raises(AssertionError, match="batch_size must divide the data mesh axis"):
        NWTrainer(net, ds, ds, batch_size=6, mesh=mesh)
    net.model.featurizer.bn = nn.BatchNorm2d(8)
    with pytest.raises(ValueError, match="syncs BatchNorm statistics only in"):
        NWTrainer(net, ds, ds, batch_size=8, mesh=mesh)
    # A checkpointed DenseNet's recompute runs in the backward, outside the
    # replicas' lockstep: refused before any replica runs.
    dense = load_model("densenet121", device="cpu", memory_efficient=True, bn_axis_name="data")
    with pytest.raises(NotImplementedError, match="memory_efficient"):
        data_parallel(dense.train(), list(torch.zeros(2, 32, 32, 3).chunk(2)), [CPU] * 2)


def test_replicas_on_another_device(monkeypatch):
    """``replicate``'s copy path (another device: here forced on the CPU):
    shallow replicas whose parameters are the model's own moved by ``.to``,
    each BatchNorm replica pointing at the model's (``_master``); synced
    replicas of them give the model's outputs, gradients and one update of
    the running statistics, as the model itself does."""
    import copy

    from nwhead_tpu_torch.parallel import data_parallel as dp

    x = torch.from_numpy(_x((8, 32, 32, 3), seed=4))
    model = load_model("CIFAR_ResNet10", device="cpu", bn_axis_name="data").train()
    ref = copy.deepcopy(model)
    monkeypatch.setattr(dp, "same_device", lambda a, b: False)
    replica = dp.replicate(model, CPU)
    assert replica is not model and replica.bn1 is not model.bn1
    assert replica.bn1.__dict__["_master"] is model.bn1
    assert replica.conv1.weight is model.conv1.weight
    got = torch.cat(data_parallel(model, list(x.chunk(4)), [CPU] * 4))
    monkeypatch.setattr(dp, "same_device", lambda a, b: True)
    want = torch.cat(data_parallel(ref, list(x.chunk(4)), [CPU] * 4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = torch.autograd.grad(got.square().sum(), list(model.parameters()))
    w = torch.autograd.grad(want.square().sum(), list(ref.parameters()))
    for a, b in zip(g, w):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for (k, v), r in zip(model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(v, r), k
    assert int(model.bn1.num_batches_tracked) == 1
