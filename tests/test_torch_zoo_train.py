"""The port's CNN zoo against the JAX package's in train mode: the
forward with batch statistics and the running statistics it updates, the
bf16 backbone, DenseNet checkpointing, and two trainer steps of
``CIFAR_ResNet10``. Weights and helpers as ``tests/test_torch_zoo.py``.
Tolerances, with the error measured here beside each:

* train mode, f32 (the running statistics updated once, as flax's
  ``mutable=["batch_stats"]``): the features at rtol=1e-3, atol=5e-3 and
  the statistics at rtol=1e-3, atol=1e-4 (measured 9.5e-5 relative at
  most: flax's E[x^2] - E[x]^2 against torch's two-pass variance). The
  CIFAR models run at 32 px, B=2; the ImageNet models at 64 px, B=4 (at
  32 px their last stage is 1x1 and a BatchNorm over 2 values rounds far
  apart in the two variance formulas);
* ``dtype=torch.bfloat16`` against JAX's ``dtype=jnp.bfloat16``: eval-mode
  features within 3e-2 of max|JAX| with cosine >= 0.999 (measured 9.6e-3
  and 1.5e-2; torch and XLA sum the bf16 convolutions in other orders and
  round to bf16, and single flips carry through the stack). In train mode
  a BatchNorm over a few values a channel amplifies every rounding: there
  the port's features and each running statistic are held to
  ``BF16_NOISE`` times the difference bf16 makes to JAX's own result
  (JAX bf16 against JAX f32; measured at most 2.2 times), plus 1e-3 of
  the statistic's largest value. One BatchNorm layer alone is held to
  flax's to 1 bf16 ulp;
* ``memory_efficient=True`` against ``False`` in the port: equal bits,
  each running statistic updated once; against JAX's ``nn.checkpoint``
  model: the features, every parameter gradient (1e-3 of its largest
  value) and the statistics;
* two ``NWTrainer`` steps of ``CIFAR_ResNet10`` (32 px, the fused K1/K3
  route, JAX's Pallas kernels in interpret mode): the loss at
  rtol=1e-4, every tensor within ``CIFAR_STEP_REL`` (15%) of how far the
  JAX step moved it (the f32 gradient of this model is ill-conditioned,
  see the constant).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nwhead_tpu.models import densenet as jdensenet
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models import densenet as tdensenet
from nwhead_tpu_torch.models import resnet as tresnet
from nwhead_tpu_torch.models.convert import jax_to_torch_featurizer, jax_to_torch_nwmodel
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.train.trainer import NWTrainer
from test_torch_zoo import SMALL_DENSE, TOL, ZOO, _fill, _jax_fns, _pair, _shapes, _x

torch.set_num_threads(1)

BF16_REL, BF16_COS = 3e-2, 0.999
BF16_NOISE = 3.0
STATS_TOL = dict(rtol=1e-3, atol=1e-4)
# Of the JAX update's size, per tensor. Every path from a CIFAR ResNet block
# to the loss runs through a train-mode BatchNorm, whose backward cancels
# most of what reaches it: at these weights the port's own f32 gradient is
# up to 9.4% of its largest entry (0.9% in norm) from the same step in f64,
# and JAX's f32 one up to 1.6%, so two f32 steps differ by up to 10% of the
# move in the deep convs (measured); ResNet-10 at 16 px holds 1%.
CIFAR_STEP_REL = 0.15


def _stats(net):
    return {k: v for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _train_size(arch):
    return (2, 32) if arch.startswith("CIFAR_") else (4, 64)


@pytest.mark.parametrize("arch", ZOO)
def test_train_forward_matches_jax(arch):
    """Batch statistics in the forward, and the running statistics after it,
    as flax updates them (momentum 0.9, the biased variance)."""
    B, size = _train_size(arch)
    x = _x((B, size, size, 3), seed=1)
    variables, net, _, fwd_train = _pair(arch, x)
    want, updated = fwd_train(variables, jnp.asarray(x))
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    want_sd = jax_to_torch_featurizer({"params": variables["params"], "batch_stats":
                                       jax.tree_util.tree_map(np.asarray, updated["batch_stats"])})
    for k, v in _stats(net).items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), **STATS_TOL, err_msg=k)
    assert all(int(b) == 1 for k, b in net.state_dict().items() if k.endswith("batches_tracked"))


@pytest.mark.parametrize("arch", ["resnet50", "densenet121"])
def test_bf16_matches_jax(arch):
    """flax's mixed precision: f32 parameters and statistics, bf16 convs,
    BatchNorm statistics and affine in f32, the pool in f32. Eval-mode
    features, then a train-mode forward's features and running statistics."""
    x = _x((2, 32, 32, 3))
    variables, net, fwd, fwd_train = _pair(arch, x, bf16=True)
    assert all(p.dtype == torch.float32 for p in net.state_dict().values() if p.is_floating_point())

    def close(got, want, what):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        rel = np.abs(got - want).max() / np.abs(want).max()
        cos = float((got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want))
        assert rel <= BF16_REL and cos >= BF16_COS, (what, rel, cos)

    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    close(got.numpy(), fwd(variables, jnp.asarray(x)), "eval")
    # Train mode: both bf16 forwards are held to how far bf16 moves JAX's
    # own result from its f32 one (batch statistics of a few values a
    # channel amplify each rounding through the stack).
    B, size = _train_size(arch)
    xt = _x((B, size, size, 3), seed=1)
    want, updated = fwd_train(variables, jnp.asarray(xt))
    want32, updated32 = _jax_fns(arch)[2](variables, jnp.asarray(xt))
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(xt)).numpy()
    want, want32 = np.asarray(want, np.float32), np.asarray(want32)
    noise = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= BF16_NOISE * noise + BF16_REL * np.abs(want).max() * 0.1
    sd, sd32 = (jax_to_torch_featurizer({"params": variables["params"], "batch_stats":
                                         jax.tree_util.tree_map(np.asarray, u["batch_stats"])})
                for u in (updated, updated32))
    for k, v in _stats(net).items():
        err, noise = float((v - sd[k]).abs().max()), float((sd[k] - sd32[k]).abs().max())
        assert err <= BF16_NOISE * noise + 1e-3 * float(sd[k].abs().max()), (k, err, noise)


def test_bf16_batchnorm_matches_flax():
    """One ``BatchNorm2d`` with ``dtype=torch.bfloat16`` against flax's
    ``BatchNorm(dtype=jnp.bfloat16)`` on the same bf16 input: the batch
    statistics in f32 from the bf16 values as E[x^2] - E[x]^2, the
    normalize and affine in f32, the output rounded to bf16 (1 bf16 ulp), the
    updated running statistics (1e-6); then eval mode on those statistics."""
    import flax.linen as fnn

    rng = np.random.default_rng(11)
    C = 24
    x = jnp.asarray(rng.standard_normal((4, 6, 6, C)) * 3 + 1, jnp.bfloat16)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    mean0 = rng.standard_normal(C).astype(np.float32) * 0.1
    var0 = (rng.random(C) + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)
    variables = {"params": {"scale": w, "bias": b}, "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, x, use_running_average=False, mutable=["batch_stats"])
    port = tresnet.BatchNorm2d(C, eps=1e-5)
    port.dtype = torch.bfloat16
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
        port.bias.copy_(torch.from_numpy(b))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    port.train()
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulp = 2.0 ** -7 * np.abs(np.asarray(want, np.float32)).max()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(want, np.float32), rtol=2.0 ** -8, atol=ulp)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    port.eval()
    with torch.no_grad():
        got = port(xt)
    want = bn.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]}, x,
                    use_running_average=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(want, np.float32), rtol=2.0 ** -8, atol=ulp)


def test_bf16_batchnorm_gradient_matches_autograd():
    """The mixed BatchNorm's hand-written backward against autograd through
    the same f32 formula, on a bf16 input."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5, 5)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 6, 5, 5)).astype(np.float32))
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    out, _, _ = tresnet._MixedBatchNorm.apply(xs, ws, bs, 1e-5, torch.float32)
    out.backward(g)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    x32 = xr.float()
    mean = x32.mean((0, 2, 3), keepdim=True)
    var = (x32.square().mean((0, 2, 3), keepdim=True) - mean.square()).clamp_min(0)
    ref = (x32 - mean) * (torch.rsqrt(var + 1e-5) * wr.view(1, -1, 1, 1)) + br.view(1, -1, 1, 1)
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xs.grad.float(), xr.grad.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(ws.grad, wr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bs.grad, br.grad, rtol=1e-5, atol=1e-5)
    assert xs.grad.dtype == torch.bfloat16


def _grads(net, x, g):
    net.zero_grad()
    out = net(x)
    out.backward(g)
    return out.detach(), {n: p.grad.clone() for n, p in net.named_parameters()}


def test_densenet_checkpointing_matches_plain_and_updates_stats_once(monkeypatch):
    """``memory_efficient=True`` against ``False`` at equal weights, one
    train step's forward and backward: features, every gradient and the
    running statistics equal, each statistic updated once (the recompute
    runs under ``frozen_running_stats``)."""
    x = torch.from_numpy(_x((2, 64, 64, 3), seed=2))
    g = torch.from_numpy(_x((2, 1024), seed=3))
    plain = load_model("densenet121", device="cpu", generator=torch.Generator().manual_seed(0))
    ckpt = load_model("densenet121", device="cpu", memory_efficient=True)
    before = copy.deepcopy(plain.state_dict())
    ckpt.load_state_dict(before)
    plain.train()
    ckpt.train()
    want, want_g = _grads(plain, x, g)
    got, got_g = _grads(ckpt, x, g)
    assert torch.equal(got, want)
    for n, v in want_g.items():
        assert torch.equal(got_g[n], v), n
    for (k, v), (k2, v2) in zip(plain.state_dict().items(), ckpt.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    assert all(int(v) == 1 for k, v in ckpt.state_dict().items() if k.endswith("batches_tracked"))
    # Without the frozen recompute (torch's own checkpoint context) the same
    # step updates every statistic of a checkpointed layer twice.
    monkeypatch.setattr(tdensenet.DenseLayer, "_recompute_context",
                        lambda self: (contextlib.nullcontext(), contextlib.nullcontext()))
    twice = load_model("densenet121", device="cpu", memory_efficient=True)
    twice.load_state_dict(before)
    twice.train()
    _grads(twice, x, g)
    layer = twice.features.denseblock1.denselayer1
    assert int(layer.norm1.num_batches_tracked) == 2
    assert not torch.equal(layer.norm1.running_mean,
                           ckpt.features.denseblock1.denselayer1.norm1.running_mean)


def test_densenet_checkpointing_matches_jax_remat():
    """The port's checkpointed layers against JAX's ``nn.checkpoint``
    (remat) model, a small DenseNet-BC: features, the gradient of every
    parameter and the running statistics after one train forward."""
    x = _x((4, 32, 32, 3), seed=4)
    model = jdensenet.DenseNet(**SMALL_DENSE, memory_efficient=True)
    variables = _fill(_shapes(model, jnp.asarray(x)), seed=5)
    g = _x((4, model.feat_dim), seed=6)

    def loss(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd)

    (_, (want, updated)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    net = tdensenet.DenseNet(**SMALL_DENSE, memory_efficient=True)
    net.load_state_dict(jax_to_torch_featurizer(variables))
    net.train()
    got, got_g = _grads(net, torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_g = jax_to_torch_featurizer({"params": jax.tree_util.tree_map(np.asarray, grads)})
    for n, v in got_g.items():
        ref = want_g[n]
        assert float((v - ref).abs().max()) <= 1e-3 * float(ref.abs().max()) + 1e-6, n
    want_sd = jax_to_torch_featurizer({"params": variables["params"], "batch_stats":
                                       jax.tree_util.tree_map(np.asarray, updated["batch_stats"])})
    for k, v in _stats(net).items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), **STATS_TOL, err_msg=k)


def test_two_trainer_steps_match_jax_cifar_resnet10():
    """Two ``NWTrainer`` steps from the same weights (``jax_to_torch_nwmodel``
    carries the CIFAR ResNet's tree), B=4 queries against a 16-row episode
    at 32 px on the fused route."""
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.train import NWTrainer as JNWTrainer

    common = dict(n_shot=4, kernel_type="euclidean", fused_min_support=16, seed=0)
    tkw = dict(lr=0.05, batch_size=4, milestones=(100,), weight_decay=1e-4,
               eval_modes=("random", "full"), seed=0)
    jtrain = jsyn(n=48, n_classes=4, size=32, seed=0)
    jval = jsyn(n=16, n_classes=4, size=32, seed=1)
    jtr = JNWTrainer(JNWNet(jload("CIFAR_ResNet10"), 4, support_dataset=jtrain, **common),
                     jtrain, jval, **tkw)
    ttrain = tdata.make_synthetic_dataset(n=48, n_classes=4, size=32, seed=0)
    tval = tdata.make_synthetic_dataset(n=16, n_classes=4, size=32, seed=1)
    tnet = NWNet(load_model("CIFAR_ResNet10", device="cpu"), 4, support_dataset=ttrain,
                 device="cpu", **common)

    def jax_state():
        return jax_to_torch_nwmodel(jax.tree_util.tree_map(
            np.asarray, {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))

    tnet.model.load_state_dict(jax_state())
    ttr = NWTrainer(tnet, ttrain, tval, **tkw)
    before = {k: v.clone() for k, v in tnet.model.state_dict().items()}
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    assert ttr.step == jtr.state.step == 2
    np.testing.assert_allclose(ttr.metrics["loss:train"].result(),
                               jtr.metrics["loss:train"].result(), rtol=1e-4)
    want, got = jax_state(), tnet.model.state_dict()
    assert "featurizer.layer2.0.shortcut.0.weight" in got
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            moved = float((v - before[k]).abs().max())
            err = float((got[k] - v).abs().max())
            assert err <= CIFAR_STEP_REL * moved + 1e-7, (k, err, moved)
