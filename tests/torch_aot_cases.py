"""Shared cases of the AOT artifact tests (``tests/test_torch_aot*.py``):
JAX ``test_aot``'s rows, a JAX net and the port's on the same weights, and
the two holds every case makes: the port's live callable against JAX's
(``JAX_TOL``), and a reloaded artifact against the live callable
(``ART_TOL``)."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART_TOL = 1e-6  # reloaded artifact vs the port's live callable (JAX test_aot's)
JAX_TOL = 2e-3  # the port's live callable vs JAX's, probabilities (serving parity tests')
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# JAX test_aot's mesh tolerance: a raw-shard live predict against the
# artifact's prepared shards (another summation order).
MESH_RTOL, MESH_ATOL = 1e-3, 1e-4
CPU8 = [torch.device("cpu")] * 8  # the mesh (2, 4) of JAX's eight virtual CPU devices


def rows(seed: int, C: int, N: int, px: int):
    """JAX ``test_aot``'s rows: N(0, 0.4) pixels shifted by class / C."""
    rng = np.random.default_rng(seed)
    y = np.tile(np.arange(C), N // C)
    x = rng.normal(0, 0.4, size=(N, px, px, 3)).astype(np.float32)
    x += (y / C)[:, None, None, None].astype(np.float32)
    return x, y


def order_one_gammas(variables):
    """A ViT's LayerScale gammas drawn from U(0.5, 1.5) (seeded), in place:
    the init's 1e-5 hides every block, so every image would get the CLS
    token's feature and the heads' argmax would be a tie. Other trees are
    returned as they are."""
    rng = np.random.default_rng(7)
    for name, block in variables["params"]["featurizer"].items():
        if name.startswith("block"):
            for g in ("ls1_gamma", "ls2_gamma"):
                block[g] = rng.uniform(0.5, 1.5, block[g].shape).astype(np.float32)
    return variables


def net_pair(arch: str, x, y, C: int, n_shot_full: int, quantize: int = 0, **kw):
    """JAX's ``NWNet`` (init from PRNGKey(0), ``fused_min_support=1``) and
    the port's on the same weights, both precomputed; with ``quantize``,
    JAX's int8 featurizer calibrated on ``x[:quantize]`` and carried into
    the port's. A ViT gets LayerScale gammas of order 1
    (``order_one_gammas``). Returns ``(jnet, variables, tnet)``."""
    from nwhead_tpu.data import ArrayDataset as JArrayDataset
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu_torch.data.datasets import ArrayDataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.models import convert
    from nwhead_tpu_torch.nw.net import NWNet

    jmodel = jload(arch)
    common = dict(feat_dim=jmodel.feat_dim, n_shot_full=n_shot_full, fused_min_support=1,
                  seed=0, **kw)
    jnet = JNWNet(jmodel, C, support_dataset=JArrayDataset(x, y, num_classes=C), **common)
    variables = order_one_gammas(jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))))
    tnet = NWNet(load_model(arch, device="cpu"), C,
                 support_dataset=ArrayDataset(x, y, num_classes=C), device="cpu", **common)
    tnet.model.load_state_dict(convert.jax_to_torch_nwmodel(variables))
    if quantize:
        jnet.quantize_featurizer(variables, x[:quantize])
        carry = {"QuantizedViT": convert.jax_to_torch_quantized_vit,
                 "QuantizedResNet": convert.jax_to_torch_quantized_resnet}
        tnet.serving_featurizer = carry[type(jnet.quantized_featurizer).__name__](
            jnet.quantized_featurizer)
        tnet._record_source()
    jnet.precompute(variables)
    tnet.precompute()
    return jnet, variables, tnet


def live_matches_jax(tfn, jfn, q):
    """The port's live callable against JAX's: probabilities within
    ``JAX_TOL``, the same argmax. Returns the port's log-probs."""
    got = tfn(q).numpy()
    want = np.asarray(jfn(jnp.asarray(q)))
    np.testing.assert_allclose(np.exp(got), np.exp(want), atol=JAX_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    return got


def roundtrip(fn, q, art: str):
    """Export ``fn`` on ``q``, reload it, and hold the reloaded program to
    ``fn`` at ``ART_TOL``. Returns the metadata."""
    from nwhead_tpu_torch.utils.aot import export_serving_artifact, load_serving_artifact

    want = fn(q).numpy()
    meta = export_serving_artifact(fn, q, art)
    reloaded = load_serving_artifact(art)
    got = reloaded(q).numpy()
    np.testing.assert_allclose(got, want, rtol=ART_TOL, atol=ART_TOL)
    assert reloaded.meta == meta
    return meta


def mesh_live_matches_jax(jnet, variables, tnet, x):
    """The port's live mesh predict against JAX's: probabilities within
    ``JAX_TOL``, the same argmax. Returns the port's log-probs."""
    got = tnet.predict(x, "full").numpy()
    want = np.asarray(jnet.predict(variables, jnp.asarray(x), "full"))
    np.testing.assert_allclose(np.exp(got), np.exp(want), atol=JAX_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    return got


def mesh_held(got, live):
    """A reloaded mesh artifact against the live mesh callable: JAX's mesh
    tolerance, the same argmax, probabilities summing to 1."""
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, live, rtol=MESH_RTOL, atol=MESH_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), live.argmax(-1))
