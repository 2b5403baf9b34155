"""Cluster mode of the port against the JAX package.

* ``batched_kmeans`` from JAX's own kmeans++ seeds (``jax.vmap`` of
  ``_kmeanspp_init`` over ``jax.random.split(PRNGKey(seed), C)``, passed as
  ``init=``) equals JAX's ``batched_kmeans(PRNGKey(seed), ...)`` within
  1e-5, for k of 1, 3 and 6, ragged masks and classes with empty clusters.
  The port seeds from a ``torch.Generator``: the same seed gives the same
  bits, every centroid finite.
* ``compute_clusters(impl="sklearn")`` is bit-exact with JAX's, ``closest``
  or not; the device path, seeded as JAX seeds, within 1e-5.
* ``SupportSetEval``'s cluster bank on the same installed bank features.
* ``NWNet.predict("cluster")`` on converted weights and the JAX bank's
  features, ``cluster_impl="sklearn"``: within 2e-4, on the naive head and,
  with ``fused_min_support`` below the cluster bank's rows, on the fused
  route's plain version (JAX's Pallas kernel in interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu.ops import kmeans as jk
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.nw.support import SupportSetEval
from nwhead_tpu_torch.ops import kmeans as tk

torch.set_num_threads(1)

KM_TOL = 1e-5


def _jax_seeds(x: np.ndarray, mask: np.ndarray, k: int, seed: int) -> np.ndarray:
    keys = jax.random.split(jax.random.PRNGKey(seed), x.shape[0])
    return np.asarray(jax.vmap(lambda kk, xx, mm: jk._kmeanspp_init(kk, xx, mm, k))(
        keys, jnp.asarray(x), jnp.asarray(mask)))


def _classes(case: str, rng):
    """(x (5, 29, 16), mask): a ragged mask (one class to 20 rows, one to
    7), or classes whose rows coincide so some clusters stay empty."""
    C, n, d = 5, 29, 16
    x = rng.standard_normal((C, n, d)).astype(np.float32)
    mask = np.ones((C, n), np.float32)
    mask[1, 20:] = 0.0
    mask[3, 7:] = 0.0
    if case == "empty":
        x[0] = x[0, :1]  # every row the same point: one cluster takes them all
        x[2, :15] = x[2, 0]  # half the rows on one point
        mask[4, 2:] = 0.0  # fewer valid rows than clusters
    x[mask == 0] = 0.0
    return x, mask


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("case", ["ragged", "empty"])
def test_batched_kmeans_matches_jax_from_its_seeds(k, case):
    rng = np.random.default_rng(k)
    x, mask = _classes(case, rng)
    seed = 7
    want = np.asarray(jk.batched_kmeans(jax.random.PRNGKey(seed), jnp.asarray(x),
                                        jnp.asarray(mask), k))
    init = _jax_seeds(x, mask, k, seed)
    got = tk.batched_kmeans(torch.from_numpy(x), torch.from_numpy(mask), k,
                            init=torch.from_numpy(init)).numpy()
    assert got.shape == (5, k, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=KM_TOL)


def test_batched_kmeans_class_chunks_match_one_pass(monkeypatch):
    """Classes fitted in chunks (the difference tensor's byte cap, here
    forced to one class a chunk) give the one-pass centroids."""
    x, mask = _classes("ragged", np.random.default_rng(0))
    init = _jax_seeds(x, mask, 3, 0)
    one = tk.batched_kmeans(torch.from_numpy(x), torch.from_numpy(mask), 3,
                            init=torch.from_numpy(init))
    monkeypatch.setattr(tk, "_CHUNK_BYTES", 1)
    chunked = tk.batched_kmeans(torch.from_numpy(x), torch.from_numpy(mask), 3,
                                init=torch.from_numpy(init))
    assert torch.equal(one, chunked)


def test_own_seeding_is_deterministic_and_finite():
    x, mask = _classes("empty", np.random.default_rng(1))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    a = tk.batched_kmeans(xt, mt, 6, seed=3)
    b = tk.batched_kmeans(xt, mt, 6, seed=3)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    init = tk.kmeanspp_init(xt, mt, 6, torch.Generator().manual_seed(3))
    # every seed is a valid row of its class
    for c in range(5):
        rows = xt[c][mt[c] > 0]
        assert all(bool((rows == cent).all(-1).any()) for cent in init[c])


def _bank(rng, n_rows=70, d=12, n_classes=4):
    emb = rng.standard_normal((n_rows, d)).astype(np.float32)
    labels = rng.permutation(np.arange(n_rows) % n_classes) + 3  # classes 3..6, unsorted
    return emb, labels


@pytest.mark.parametrize("closest", [False, True])
def test_compute_clusters_sklearn_bit_exact(closest):
    pytest.importorskip("sklearn")
    emb, labels = _bank(np.random.default_rng(2))
    want_f, want_y = jk.compute_clusters(emb, labels, 3, closest=closest, impl="sklearn")
    got_f, got_y = tk.compute_clusters(torch.from_numpy(emb), labels, 3, closest=closest,
                                       impl="sklearn")
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    assert got_f.dtype == torch.float32 and got_y.dtype == torch.int64


def _use_jax_seeds(monkeypatch, seed=0):
    """The port's kmeans++ replaced by JAX's draws for ``PRNGKey(seed)``."""
    def jax_init(x, mask, k, generator):
        return torch.from_numpy(_jax_seeds(x.numpy(), mask.numpy(), k, seed))

    monkeypatch.setattr(tk, "kmeanspp_init", jax_init)


@pytest.mark.parametrize("closest", [False, True])
def test_compute_clusters_device_matches_jax_on_its_seeds(monkeypatch, closest):
    emb, labels = _bank(np.random.default_rng(3))
    _use_jax_seeds(monkeypatch)
    want_f, want_y = jk.compute_clusters(emb, labels, 3, closest=closest)
    got_f, got_y = tk.compute_clusters(torch.from_numpy(emb), labels, 3, closest=closest)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=KM_TOL)
    np.testing.assert_array_equal(got_y.numpy(), want_y)


def test_compute_clusters_refuses_unknown_impl():
    emb, labels = _bank(np.random.default_rng(0))
    with pytest.raises(ValueError, match="impl"):
        tk.compute_clusters(torch.from_numpy(emb), labels, 2, impl="faiss")


@pytest.mark.parametrize("impl", ["device", "sklearn"])
def test_support_eval_cluster_bank_matches_jax(monkeypatch, impl):
    if impl == "sklearn":
        pytest.importorskip("sklearn")
    from nwhead_tpu.nw.support import SupportSetEval as JaxSupportSetEval

    rng = np.random.default_rng(4)
    targets = np.arange(60) % 5
    jse = JaxSupportSetEval(targets, 5, n_shot_full=10, n_shot_cluster=2, seed=0,
                            cluster_impl=impl)
    tse = SupportSetEval(targets, 5, n_shot_full=10, n_shot_cluster=2, seed=0,
                         cluster_impl=impl)
    idx = np.concatenate(tse.full_bank_indices)
    np.testing.assert_array_equal(idx, np.concatenate(jse.full_bank_indices))
    feat = rng.standard_normal((len(idx), 8)).astype(np.float32)
    sy = targets[idx]
    meta = np.zeros(len(idx), np.int64)
    jse.build_infer_iters(feat, sy, meta, [feat], [sy], [meta])
    _use_jax_seeds(monkeypatch)
    tse.build_infer_iters(torch.from_numpy(feat), sy)
    got_f, got_y = tse.get_support("cluster")
    want_f, want_y = jse.get_support("cluster")
    assert got_f.shape == (10, 8)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=0 if impl == "sklearn" else KM_TOL)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    with pytest.raises(NotImplementedError, match="item 6"):
        tse.get_support("knn")


@pytest.mark.parametrize("fused_min_support", [1024, 8])
def test_predict_cluster_matches_jax(fused_min_support):
    """Both nets on the same weights, the JAX bank's features installed in
    both, clusters by sklearn (bit-identical): the cluster-mode log-probs.
    At ``fused_min_support`` 8 the 12-row cluster bank takes the fused
    route (the port's plain K1, JAX's Pallas kernel in interpret mode)."""
    pytest.importorskip("sklearn")
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JaxNWNet

    common = dict(n_shot_full=8, n_shot_cluster=3, cluster_impl="sklearn",
                  fused_min_support=fused_min_support)
    jtrain, val = jsyn(n=48, n_classes=4, size=32, seed=0), jsyn(n=16, n_classes=4, size=32,
                                                                seed=1)
    jnet = JaxNWNet(jload("resnet10"), 4, support_dataset=jtrain, **common)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(jtrain.gather(np.arange(8))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jnet.precompute(variables)
    x = val.gather(np.arange(16))
    want = np.asarray(jnet.predict(variables, jnp.asarray(x), mode="cluster"))

    ttrain = tdata.make_synthetic_dataset(n=48, n_classes=4, size=32, seed=0)
    tnet = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ttrain, device="cpu",
                 **common)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(variables))
    tnet.support_eval.build_infer_iters(torch.from_numpy(np.asarray(jnet.full_feat)),
                                        np.asarray(jnet.full_y))
    tnet._build_serving_banks()
    sfeat, sy = tnet.support_eval.get_support("cluster")
    assert sfeat.shape == (12, 512)
    assert tnet.model.head.takes_fused(sfeat[:1], sfeat) == (fused_min_support <= 12)
    np.testing.assert_array_equal(sfeat.numpy(), np.asarray(jnet.support_eval.cluster_feat))
    got = tnet.predict(x, mode="cluster").numpy()
    assert got.shape == (16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
