"""The port's ResNet against the JAX package's, with the JAX weights carried
in by ``jax_to_torch_resnet``. Eval-mode features at rtol=1e-3, atol=5e-3,
the bound ``tests/test_models.py`` holds the JAX model to against torch
(conv summation order through a deep stack)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu.models import load_model as jax_load_model
from nwhead_tpu.models.torch_import import convert_state_dict
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_head, jax_to_torch_resnet

torch.set_num_threads(1)


def _jax_variables(arch, x):
    """JAX init, with BatchNorm statistics moved off (0, 1) so that eval-mode
    parity is not trivial."""
    model = jax_load_model(arch)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.standard_normal(v.shape) * 0.1 if path[-1].key == "mean"
                         else rng.random(v.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("arch,size", [("resnet10", 32), ("resnet18", 64)])
def test_resnet_features_match_jax(arch, size):
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    model, variables = _jax_variables(arch, x)
    want = np.asarray(model.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), train=False))
    net = load_model(arch, device="cpu")
    net.load_state_dict(jax_to_torch_resnet(variables))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, net.feat_dim) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ["resnet10", "resnet18"])
def test_state_dict_round_trip(arch):
    """JAX tree -> port state_dict -> the JAX package's torchvision importer
    gives back the same tree, leaf for leaf."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    _, variables = _jax_variables(arch, x)
    sd = jax_to_torch_resnet(variables)
    net = load_model(arch, device="cpu")
    net.load_state_dict(sd)  # strict: every key named as torchvision names it
    assert "layer2.0.downsample.0.weight" in sd and "layer1.0.conv1.weight" in sd
    back = convert_state_dict(net.state_dict(), arch)
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_seeded_init_and_registry():
    a = load_model("resnet10", device="cpu", generator=torch.Generator().manual_seed(3))
    b = load_model("resnet10", device="cpu", generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not a.training
    # Kaiming-normal fan-out: std = sqrt(2 / (out_channels * k * k)).
    w = a.layer4[0].conv1.weight.detach()
    assert abs(float(w.std()) - (2.0 / (512 * 9)) ** 0.5) < 2e-3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model("resnet50", device="cpu")
    assert jax_to_torch_head({}) == {}
    head = jax_to_torch_head({"logit_scale": np.float32(2.5)})
    assert float(head["logit_scale"]) == 2.5
