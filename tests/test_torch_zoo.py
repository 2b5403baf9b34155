"""The port's CNN zoo against the JAX package's: the models themselves.

The JAX weights are carried in by ``models/convert.py`` and the same numpy
inputs go through both. The flax trees come from ``jax.eval_shape`` of
``init`` filled from a numpy generator (Kaiming-normal fan-out kernels,
BatchNorm scales in [0.5, 1.5], biases and statistics off (0, 1): ``_fill``),
so that nothing is compiled for an init and eval-mode parity is not
trivial; each JAX forward is jitted. ``tests/test_torch_zoo_train.py``
holds the train-mode, bf16 and checkpointing checks, and imports the
helpers here.

* eval-mode features, f32, 32 px, B=2, for ``ZOO``: rtol=1e-3, atol=5e-3
  (the bound of ``tests/test_torch_resnet.py``; measured at most 1.5e-6
  of max|feature|);
* the other names of the registry without a forward: the port's
  ``feature_dim`` against JAX's, and every parameter's and statistic's
  shape against ``jax.eval_shape(model.init, ...)`` carried through the
  converter;
* the ``s2d`` stem against ``conv7`` on the same weights (1e-5) and against
  JAX's ``s2d`` model; DenseNet dropout leaves eval mode untouched; the
  per-family options.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nwhead_tpu.models import MODEL_NAMES as JAX_MODEL_NAMES
from nwhead_tpu.models import feature_dim as jax_feature_dim
from nwhead_tpu.models import load_model as jax_load_model
from nwhead_tpu.models import resnet as jresnet
from nwhead_tpu_torch.models import MODEL_NAMES, VIT_NAMES, feature_dim, load_model
from nwhead_tpu_torch.models import densenet as tdensenet
from nwhead_tpu_torch.models import resnet as tresnet
from nwhead_tpu_torch.models.convert import jax_to_torch_featurizer

torch.set_num_threads(1)

ZOO = ("resnet34", "resnet50", "resnext50_32x4d", "CIFAR_ResNet10", "CIFAR_ResNet18",
       "densenet121", "CIFAR_DenseNet121")
OTHERS = tuple(n for n in MODEL_NAMES if n not in ZOO)
TOL = dict(rtol=1e-3, atol=5e-3)
SMALL_DENSE = dict(growth_rate=8, block_config=(2, 3), num_init_features=16)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _shapes(model, x):
    return jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0), x)


def _fill(shapes, seed=0):
    """Numpy leaves for a flax CNN tree of ``ShapeDtypeStruct``s."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":  # HWIO, Kaiming-normal fan-out
            fan_out = int(np.prod(s.shape[:2])) * s.shape[-1]
            return rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_out)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "var":
            return rng.random(s.shape) + 0.5
        return rng.standard_normal(s.shape) * 0.1  # bias, mean

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _jax_fns(arch, bf16=False, **kw):
    model = jax_load_model(arch, dtype=jnp.bfloat16 if bf16 else None, **kw)
    return (model, jax.jit(lambda v, x: model.apply(v, x, train=False)),
            jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"])))


def _pair(arch, x, bf16=False, **kw):
    """(JAX model, numpy variables, the port's model with them, eval fn,
    train fn)."""
    model, fwd, fwd_train = _jax_fns(arch, bf16, **kw)
    variables = _fill(_shapes(model, jnp.asarray(x)))
    net = load_model(arch, device="cpu", dtype=torch.bfloat16 if bf16 else None, **kw)
    net.load_state_dict(jax_to_torch_featurizer(variables))
    return variables, net, fwd, fwd_train


def test_registry_matches_jax():
    assert MODEL_NAMES == JAX_MODEL_NAMES


@pytest.mark.parametrize("arch", ZOO)
def test_eval_features_match_jax(arch):
    x = _x((2, 32, 32, 3))
    variables, net, fwd, _ = _pair(arch, x)
    want = np.asarray(fwd(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, net.feat_dim) == want.shape and net.feat_dim == jax_feature_dim(arch)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", OTHERS)
def test_other_names_match_jax_shapes(name):
    """``feature_dim`` and every parameter's and statistic's shape, without
    a forward."""
    assert feature_dim(name) == jax_feature_dim(name)
    size = 28 if name in VIT_NAMES else 32
    shapes = _shapes(jax_load_model(name), jnp.zeros((1, size, size, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in jax_to_torch_featurizer(zeros).items()}
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in load_model(name, device="meta").state_dict().items()}
    assert got == want


def test_densenet_dropout_leaves_eval_untouched():
    """``drop_rate`` only acts in train mode, with the layer's own generator:
    eval features equal the model's without dropout, train features drop
    about the rate of a layer's new maps and repeat under the same seed."""
    x = torch.from_numpy(_x((2, 32, 32, 3), seed=7))
    ref = tdensenet.DenseNet(**SMALL_DENSE).eval()
    drop = tdensenet.DenseNet(**SMALL_DENSE, drop_rate=0.5).eval()
    drop.load_state_dict(ref.state_dict())
    with torch.no_grad():
        assert torch.equal(drop(x), ref(x))
    layer = drop.features.denseblock1.denselayer1
    layer.train()
    h = x.permute(0, 3, 1, 2)[:, :1].expand(2, 16, 32, 32).contiguous()
    keep = layer._keep_mask(h)
    assert keep.shape == (2, 8, 32, 32)
    assert abs(float((keep == 0).float().mean()) - 0.5) < 0.05
    assert set(np.unique(keep.numpy())) <= {0.0, 2.0}
    again = tdensenet.DenseNet(**SMALL_DENSE, drop_rate=0.5).features.denseblock1.denselayer1
    assert torch.equal(again._keep_mask(h), keep)


def test_s2d_stem_matches_conv7_and_jax():
    """The space-to-depth stem with ``s2d_stem_kernel`` of a 7x7 kernel gives
    the 7x7/s2 stem's features; and the port's s2d model matches JAX's."""
    x = _x((2, 32, 32, 3), seed=8)
    conv7 = load_model("resnet10", device="cpu", generator=torch.Generator().manual_seed(1))
    s2d = load_model("resnet10", device="cpu", stem="s2d")
    sd = conv7.state_dict()
    sd["conv1.weight"] = tresnet.s2d_stem_kernel(sd["conv1.weight"])
    s2d.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(torch.from_numpy(x)).numpy(),
                                   conv7(torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)
    # The port's kernel transform is the JAX package's, in OIHW.
    w7 = _x((64, 3, 7, 7), seed=9)
    want = jresnet.s2d_stem_kernel(w7.transpose(2, 3, 1, 0)).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(tresnet.s2d_stem_kernel(torch.from_numpy(w7)).numpy(), want)
    variables, net, fwd, _ = _pair("resnet10", x, stem="s2d")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fwd(variables, jnp.asarray(x))), **TOL)


def test_zero_init_residual_and_options():
    net = load_model("resnet50", device="meta", zero_init_residual=True)
    assert isinstance(net.layer1[0].last_bn, tresnet.BatchNorm2d)
    real = tresnet.resnet10(zero_init_residual=True)
    assert all(float(b.bn2.weight.abs().max()) == 0 for b in real.modules()
               if isinstance(b, tresnet.BasicBlock))
    assert float(real.bn1.weight.min()) == 1.0
    for name, bad in (("CIFAR_ResNet18", "stem"), ("resnet50", "memory_efficient"),
                      ("densenet121", "zero_init_residual"), ("resnet18", "attn_impl"),
                      ("densenet121", "bn_axis_name")):
        with pytest.raises(ValueError, match="takes no"):
            load_model(name, device="meta", **{bad: True})
    with pytest.raises(ValueError, match="dtype"):
        load_model("resnet10", device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="stem"):
        load_model("resnet10", device="meta", stem="s4d")
