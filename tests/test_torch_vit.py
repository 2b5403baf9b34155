"""The port's ViT against the JAX package's on the same numpy weights.

A small ViT (patch 8, D=64, depth 2, 2 heads, a stored 6x6 position grid
resampled to the 4x4 grid of 32 px images) carries the flax model's
initialized weights through ``jax_to_torch_vit``, with LayerScale gammas of
order 1 drawn from a seed (at the init's 1e-5 each block adds almost
nothing, and a wrong block would pass). Tolerances, with the error measured
here beside each:

* ``VisionTransformer`` f32, ``xla`` and ``fused``: rtol=atol=1e-4
  (measured 1.6e-6 and 1.5e-6 absolute);
* bf16: 3e-2 of max|flax| (``xla`` 1.0e-2: torch and XLA sum the bf16
  products of the einsums and Dense layers in other orders and round the
  sums to bf16, and single flips carry through the blocks; ``fused`` 0,
  the same values);
* ``ServingViT`` against ``fuse_vit_serving(...).apply``: cosine >= 0.9999
  and 1e-2 of max|JAX| (cosine 0.9999999, error 0);
* ``_interpolate_pos_embed`` against ``jax.image.resize(..., "bicubic")`` at
  37 -> 16 and 14 -> 16: 1e-5 (8.9e-7 and 4.8e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nwhead_tpu.models import vit as jvit
from nwhead_tpu.models.serving_vit import fuse_vit_serving as jax_fuse_vit_serving
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models import vit as tvit
from nwhead_tpu_torch.models.convert import jax_to_torch_vit
from nwhead_tpu_torch.models.serving_vit import ServingViT, fuse_vit_serving

torch.set_num_threads(1)

SMALL = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=48)


def _jax_vit(**kw):
    return jvit.VisionTransformer(**SMALL, **kw)


def _torch_vit(**kw):
    return tvit.VisionTransformer(**SMALL, **kw)


def _variables(seed=0):
    """The flax model's init as numpy, with LayerScale gammas in [0.5, 1.5]."""
    images = np.random.default_rng(seed).standard_normal((3, 32, 32, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, _jax_vit().init(jax.random.PRNGKey(seed), jnp.asarray(images)))
    rng = np.random.default_rng(100 + seed)
    for i in range(SMALL["depth"]):
        for g in ("ls1_gamma", "ls2_gamma"):
            variables["params"][f"block{i}"][g] = rng.uniform(0.5, 1.5, SMALL["embed_dim"]).astype(
                np.float32)
    return variables, images


def test_jax_to_torch_vit_round_trip():
    """Every flax leaf lands in the port's state dict, in the port's layout,
    and every port parameter comes from one."""
    variables, _ = _variables()
    sd = jax_to_torch_vit(variables)
    model = _torch_vit()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    p = variables["params"]
    np.testing.assert_array_equal(model.patch_embed.weight.detach().numpy(),
                                  p["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.pos_embed.detach().numpy(), p["pos_embed"])
    np.testing.assert_array_equal(model.cls_token.detach().numpy(), p["cls_token"])
    for i, blk in enumerate(model.blocks):
        bp = p[f"block{i}"]
        np.testing.assert_array_equal(blk.attn.qkv.weight.detach().numpy(),
                                      bp["attn"]["qkv"]["kernel"].T)
        np.testing.assert_array_equal(blk.mlp.fc2.bias.detach().numpy(), bp["mlp"]["fc2"]["bias"])
        np.testing.assert_array_equal(blk.norm2.weight.detach().numpy(), bp["norm2"]["scale"])
        np.testing.assert_array_equal(blk.ls2_gamma.detach().numpy(), bp["ls2_gamma"])
    np.testing.assert_array_equal(model.norm.bias.detach().numpy(), p["norm"]["bias"])


@pytest.mark.parametrize("g_orig,g_new", [(37, 16), (14, 16)])
def test_interpolate_pos_embed_matches_jax_resize(g_orig, g_new):
    pos = np.random.default_rng(g_orig).standard_normal((1, g_orig * g_orig, 24)).astype(
        np.float32)
    want = np.asarray(jvit._interpolate_pos_embed(jnp.asarray(pos), g_new * g_new, g_new, g_new))
    got = tvit._interpolate_pos_embed(torch.from_numpy(pos), g_new * g_new, g_new, g_new).numpy()
    assert got.shape == want.shape == (1, g_new * g_new, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_vision_transformer_matches_flax(impl, dtype):
    variables, images = _variables(seed=1)
    jdt, tdt = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(_jax_vit(dtype=jdt, attn_impl=impl, mlp_impl=impl).apply(
        variables, jnp.asarray(images), train=False))
    model = _torch_vit(dtype=tdt, attn_impl=impl, mlp_impl=impl)
    model.load_state_dict(jax_to_torch_vit(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == (3, 64) and got.dtype == np.float32 and want.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_serving_vit_matches_jax():
    variables, images = _variables(seed=2)
    want = np.asarray(jax_fuse_vit_serving(_jax_vit(), variables).apply(jnp.asarray(images)))
    model = _torch_vit()
    model.load_state_dict(jax_to_torch_vit(variables))
    serving = fuse_vit_serving(model)
    assert isinstance(serving, ServingViT) and not list(serving.parameters())
    got = serving(torch.from_numpy(images)).numpy()
    assert got.shape == (3, 64) and got.dtype == np.float32
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.9999
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_load_model_registers_the_vits_and_passes_options():
    gen = torch.Generator().manual_seed(0)
    shapes = {"vit_s14": (14, 384, 12, 6), "dinov2_vits14": (14, 384, 12, 6),
              "vit_b14": (14, 768, 12, 12), "vit_s16": (16, 384, 12, 6)}
    for name, (p, d, depth, h) in shapes.items():
        m = load_model(name, device="meta", generator=None)
        assert (m.patch_size, m.feat_dim, len(m.blocks), m.num_heads) == (p, d, depth, h)
    m = load_model("vit_s16", device="cpu", generator=gen, attn_impl="fused", mlp_impl="fused",
                   dtype=torch.bfloat16, layerscale_init=0.5)
    assert m.blocks[0].attn.attn_impl == "fused" and m.blocks[0].mlp.mlp_impl == "fused"
    assert m.dtype == torch.bfloat16 and float(m.blocks[3].ls2_gamma[7].detach()) == 0.5
    assert m.pos_embed.shape == (1, 14 * 14 + 1, 384)
    with pytest.raises(ValueError, match="attn_impl"):
        load_model("resnet10", device="cpu", attn_impl="fused")
