"""The ensemble, knn and hnsw modes of the port against the JAX package.

* ``knn_indices``, ``knn_indices_chunked`` and ``ExactKNN``: the same ids as
  JAX's, in order, on a bank of small-integer features (every distance
  exact, ties everywhere, duplicated rows straddling the k boundary) and on
  a random one; k beyond the bank raises in both.
* ``HNSWIndex``: built from the port's own copy of ``hnsw.cpp``, the same
  ids as JAX's index on the same rows and seed (the two libraries come from
  one source with one set of flags), before and after ``add_items``;
  recall@10 > 0.9 against exact, self-queries, the flat union gathered from
  the bank's tensor; a build that fails raises.
* ``SupportSetEval``'s environment lists and stacked ensemble banks on
  uneven environments (21 / 24 rows), and its knn union, equal JAX's.
* ``NWNet.predict`` in ``ensemble``, ``knn`` and ``hnsw`` on converted
  ResNet-10 weights within 1e-4 of JAX's ``NWNet``, on the naive head and
  with ``fused_min_support`` 16, where every union and environment bank
  takes the fused route's plain K1; ``return_mask`` and
  ``process_support_eval``.
* The sharded ensemble and knn on meshes (1,8), (2,4) and (4,2) of CPU
  devices against JAX's on the eight virtual devices of
  ``tests/conftest.py`` and against the port unsharded; masked rows never
  enter the knn union; ``NWNet(mesh=...)`` takes both.
* ``gpu``: the ensemble and knn through K1 (and K1 ``partials``, sharded
  on one card) against their plain versions.

JAX is imported inside the tests that compare with it.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from nwhead_tpu_torch.native import hnsw as thnsw
from nwhead_tpu_torch.nw.support import SupportSetEval
from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops import knn as tknn
from nwhead_tpu_torch.ops import nw as tnw
from nwhead_tpu_torch.parallel import (
    make_mesh, sharded_ensemble_predict_fn, sharded_knn_predict_fn,
)

torch.set_num_threads(1)

MESHES = ((1, 8), (2, 4), (4, 2))
CPU8 = [torch.device("cpu")] * 8
TOL = 1e-4
SHARD_TOL = 2e-4


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _bank(case: str, rng, S=40, D=6):
    """Small-integer features (exact distances, ties everywhere, each row
    twice) or a random bank; queries near the first rows."""
    if case == "ties":
        base = rng.integers(-2, 3, size=(S // 2, D)).astype(np.float32)
        bank = np.repeat(base, 2, axis=0)
        q = rng.integers(-2, 3, size=(7, D)).astype(np.float32)
    else:
        bank = rng.standard_normal((S, D)).astype(np.float32)
        q = (bank[:7] + 0.05 * rng.standard_normal((7, D))).astype(np.float32)
    return bank, q


# ---------------------------------------------------------------------------
# ops/knn.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("case", ["ties", "random"])
def test_knn_indices_match_jax(case, k):
    jax, jnp = _jax()
    from nwhead_tpu.ops import knn as jknn

    bank, q = _bank(case, np.random.default_rng(k))
    want = np.asarray(jknn.knn_indices(jnp.asarray(q), jnp.asarray(bank), k))
    got = tknn.knn_indices(torch.from_numpy(q), torch.from_numpy(bank), k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    want_c = np.asarray(jknn.knn_indices_chunked(jnp.asarray(q), jnp.asarray(bank), k, chunk=8))
    got_c = tknn.knn_indices_chunked(torch.from_numpy(q), torch.from_numpy(bank), k, chunk=8)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_c.numpy(), want)
    if case == "ties":  # a duplicated pair is cut by the k boundary somewhere
        d2 = ((q[:, None] - bank[None]) ** 2).sum(-1)
        kth = np.sort(d2, 1)[:, k - 1]
        assert ((d2 == kth[:, None]).sum(1) > (np.sort(d2, 1)[:, :k] == kth[:, None]).sum(1)).any()


@pytest.mark.parametrize("case", ["ties", "random"])
def test_exact_knn_matches_jax(case):
    jax, jnp = _jax()
    from nwhead_tpu.ops.knn import ExactKNN as JaxKNN

    rng = np.random.default_rng(11)
    bank, q = _bank(case, rng)
    labels = rng.integers(0, 5, len(bank))
    want_f, want_y = JaxKNN(bank, labels, n_neighbors=4)(jnp.asarray(q))
    got_f, got_y = tknn.ExactKNN(torch.from_numpy(bank), torch.from_numpy(labels), 4)(
        torch.from_numpy(q))
    assert got_f.shape == (7 * 4, 6) and got_y.shape == (7 * 4,)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_y.numpy(), want_y)


def test_knn_refuses_k_beyond_the_bank():
    jax, jnp = _jax()
    from nwhead_tpu.ops import knn as jknn

    bank, q = _bank("random", np.random.default_rng(0), S=16)
    with pytest.raises(Exception):
        jknn.knn_indices(jnp.asarray(q), jnp.asarray(bank), 17)
    with pytest.raises(ValueError, match="k=17"):
        tknn.knn_indices(torch.from_numpy(q), torch.from_numpy(bank), 17)
    with pytest.raises(ValueError, match="k=5"):
        tknn.knn_indices_chunked(torch.from_numpy(q), torch.from_numpy(bank), 5, chunk=4)
    with pytest.raises(ValueError, match="chunk multiple"):
        tknn.knn_indices_chunked(torch.from_numpy(q), torch.from_numpy(bank), 3, chunk=5)


# ---------------------------------------------------------------------------
# native/hnsw.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hnsw_pair():
    from nwhead_tpu.native.hnsw import HNSWIndex as JaxHNSW

    rng = np.random.default_rng(0)
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    labels = rng.integers(0, 10, size=2000)
    return (thnsw.HNSWIndex(torch.from_numpy(data), labels, n_neighbors=10),
            JaxHNSW(data, labels, n_neighbors=10), data, labels)


def test_hnsw_ids_match_jax(hnsw_pair):
    """One source, one seed, one insertion order: the same graph, so the
    same neighbours in the same order; then recall@10 against exact."""
    port, jax_index, data, _ = hnsw_pair
    q = np.random.default_rng(1).standard_normal((50, 32)).astype(np.float32)
    got = port.knn_query(torch.from_numpy(q))
    np.testing.assert_array_equal(got, jax_index.knn_query(q))
    exact = tknn.knn_indices(torch.from_numpy(q), torch.from_numpy(data), 10).numpy()
    recall = np.mean([len(set(g) & set(e)) / 10 for g, e in zip(got.tolist(), exact.tolist())])
    assert recall > 0.9, recall


def test_hnsw_self_query_and_flat_union(hnsw_pair):
    port, _, data, labels = hnsw_pair
    assert len(port) == 2000
    np.testing.assert_array_equal(port.knn_query(data[:20], k=1)[:, 0], np.arange(20))
    sfeat, sy = port(torch.from_numpy(data[:3] + 0.001))
    assert sfeat.shape == (30, 32) and sy.shape == (30,)
    np.testing.assert_array_equal(sy.numpy()[[0, 10, 20]], labels[:3])
    ids = port.knn_query(data[:3] + 0.001).reshape(-1)
    np.testing.assert_array_equal(sfeat.numpy(), data[ids])


def test_hnsw_add_items_matches_jax():
    from nwhead_tpu.native.hnsw import HNSWIndex as JaxHNSW

    rng = np.random.default_rng(2)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    new = rng.standard_normal((60, 16)).astype(np.float32)
    labels, new_y = rng.integers(0, 5, 300), rng.integers(0, 5, 60)
    port = thnsw.HNSWIndex(torch.from_numpy(data), labels, n_neighbors=5)
    jax_index = JaxHNSW(data, labels, n_neighbors=5)
    port.add_items(torch.from_numpy(new), new_y)
    jax_index.add_items(new, new_y)
    assert len(port) == 360 and port.data.shape == (360, 16) and port.labels.shape == (360,)
    q = np.concatenate([new[:10], rng.standard_normal((10, 16)).astype(np.float32)])
    np.testing.assert_array_equal(port.knn_query(q), jax_index.knn_query(q))
    np.testing.assert_array_equal(port.knn_query(new[:10], k=1)[:, 0], 300 + np.arange(10))
    with pytest.raises(ValueError, match="expected"):
        port.add_items(np.zeros((2, 3), np.float32), [0, 1])


def test_hnsw_library_builds_in_the_package_and_failures_raise(monkeypatch, tmp_path):
    from nwhead_tpu_torch.ops import _cuda

    path = thnsw.build()
    assert path.parent == _cuda.BUILD_DIR and path.name.startswith("libhnsw_")
    index = thnsw.HNSWIndex(torch.zeros(3, 4), [0, 1, 2], n_neighbors=5)
    with pytest.raises(ValueError, match="fewer than k=5"):
        index(torch.zeros(1, 4))
    with pytest.raises(ValueError, match="queries"):
        index.knn_query(np.zeros((1, 3), np.float32))
    monkeypatch.setattr(thnsw, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(thnsw, "GXX_FLAGS", thnsw.GXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g.. failed to build hnsw.cpp"):
        thnsw.build()
    monkeypatch.setattr(thnsw.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        thnsw.build()
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# SupportSetEval
# ---------------------------------------------------------------------------

def test_support_eval_env_lists_and_ensemble_banks_match_jax():
    """Uneven environments (21 / 24 items, as JAX's ``test_end_to_end``):
    the per-environment lists, the stacked banks with their padding masked,
    and the knn union."""
    _, jnp = _jax()
    from nwhead_tpu.nw.support import SupportSetEval as JaxSupportSetEval

    targets = np.tile(np.arange(3), 15)
    env = np.array([0] * 21 + [1] * 24)
    jse = JaxSupportSetEval(targets, 3, n_shot_full=10, n_neighbors=4, env_array=env, seed=0)
    tse = SupportSetEval(targets, 3, n_shot_full=10, n_neighbors=4, env_array=env, seed=0)
    rng = np.random.default_rng(5)
    feats, ys, metas = [], [], []
    for e, idx in zip((0, 1), jse.full_bank_indices):
        feats.append(rng.standard_normal((len(idx), 8)).astype(np.float32))
        ys.append(targets[idx])
        metas.append(np.full(len(idx), e))
    assert [len(f) for f in feats] == [21, 24]
    full = np.concatenate(feats)
    args = (np.concatenate(ys), np.concatenate(metas))
    jse.build_infer_iters(full, *args, feats, ys, metas)
    tfull = torch.from_numpy(full)
    tse.build_infer_iters(tfull, *args, list(tfull.split([21, 24])), ys, metas)
    for got, want in ((tse.full_y_sep, jse.full_y_sep), (tse.full_meta_sep, jse.full_meta_sep)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tse.full_meta, jse.full_meta)
    for g, w in zip(tse.full_feat_sep, jse.full_feat_sep):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tse._ensemble_cache is None  # built at the first ensemble call
    for g, w in zip(tse.get_support("ensemble"), jse.get_support("ensemble")):
        assert g.shape == (2, 24, 8)[:g.dim()]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tse.get_support("ensemble")[0] is tse.get_support("ensemble")[0]
    q = rng.standard_normal((5, 8)).astype(np.float32)
    got_f, got_y = tse.get_support("knn", x=torch.from_numpy(q))
    want_f, want_y = jse.get_support("knn", x=jnp.asarray(q))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    with pytest.raises(NotImplementedError, match="ivf"):
        tse.get_support("ivf")


# ---------------------------------------------------------------------------
# NWNet against JAX's on converted weights
# ---------------------------------------------------------------------------

ENV = np.array([0] * 21 + [1] * 27)
NET_KW = dict(n_shot_full=6, n_neighbors=5, train_type="irm", env_array=ENV)


@pytest.fixture(scope="module")
def jax_net():
    """JAX's ResNet-10 net (naive head) over two uneven environments (20 /
    24 bank rows), precomputed, with one batch of 8 queries and its
    ensemble, knn and hnsw log-probs."""
    jax, jnp = _jax()
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JaxNWNet

    jtrain = jsyn(n=48, n_classes=4, size=32, seed=0)
    jnet = JaxNWNet(jload("resnet10"), 4, support_dataset=jtrain, **NET_KW)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(jtrain.gather(np.arange(8))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jnet.precompute(variables)
    x = jsyn(n=16, n_classes=4, size=32, seed=1).gather(np.arange(8))
    want = {m: np.asarray(jnet.predict(variables, jnp.asarray(x), mode=m))
            for m in ("ensemble", "knn", "hnsw")}
    return jnet, variables, x, want


def _port_net(variables, dataset=None, **kw):
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
    from nwhead_tpu_torch.nw.net import NWNet

    if dataset is None:
        dataset = make_synthetic_dataset(n=48, n_classes=4, size=32, seed=0)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=dataset,
                device="cpu", **{**NET_KW, **kw})
    net.model.load_state_dict(jax_to_torch_nwmodel(variables))
    return net


@pytest.mark.parametrize("fused_min_support", [1024, 16])
@pytest.mark.parametrize("mode", ["ensemble", "knn", "hnsw"])
def test_predict_matches_jax(jax_net, mode, fused_min_support):
    """The port's own precompute (environment by environment) and predict
    against JAX's; at ``fused_min_support`` 16 the 40-row unions and the
    24-row environment banks take the fused route (the plain K1, padding
    rows masked)."""
    _, jnp = _jax()
    from nwhead_tpu.ops.knn import knn_indices as jax_knn

    jnet, variables, x, want = jax_net
    net = _port_net(variables, fused_min_support=fused_min_support)
    net.precompute()
    se = net.support_eval
    assert [len(f) for f in se.full_feat_sep] == [20, 24]
    np.testing.assert_allclose(se.full_feat.numpy(), np.asarray(jnet.full_feat), atol=1e-5)
    got = net.predict(x, mode)
    assert got.shape == (8, 4) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want[mode], rtol=TOL, atol=TOL)
    qfeat = net._featurize_eval(torch.from_numpy(x))
    if mode == "ensemble":
        support = se.get_support("ensemble")[0][0]
    else:
        support = se.get_support(mode, x=qfeat)[0]
        assert support.shape == (8 * 5, 512)
    assert net.model.head.takes_fused(qfeat, support) == (fused_min_support == 16)
    if mode == "knn":  # the ids themselves: JAX's search on JAX's bank and features
        jq = jnet._featurize_eval(variables, jnp.asarray(x))
        np.testing.assert_array_equal(se.knn.indices(qfeat).numpy(),
                                      np.asarray(jax_knn(jq, jnet.full_feat, 5)))


def test_support_influence_over_the_knn_union_matches_jax(jax_net):
    """Influence in knn mode: each of the union's B * k rows on each query
    (the union built from the queries' own features, as in JAX)."""
    _, jnp = _jax()
    jnet, variables, x, _ = jax_net
    y = np.arange(8) % 4
    want = jnet.support_influence(variables, jnp.asarray(x), y, mode="knn")
    net = _port_net(variables)
    net.precompute()
    got = net.support_influence(x, y, mode="knn")
    assert got.shape == (8, 8 * 5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_predict_return_mask_and_process_support_eval(jax_net):
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset

    _, variables, x, want = jax_net
    net = _port_net(variables, return_mask=True)
    net.precompute()
    out, mask = net.predict(x, "ensemble")
    np.testing.assert_allclose(out.numpy(), want["ensemble"], rtol=TOL, atol=TOL)
    assert mask.dtype == bool and mask.shape == (8,) and mask.all()
    other = make_synthetic_dataset(n=24, n_classes=4, size=32, seed=3)
    net.process_support_eval(other, n_shot_full=3, n_neighbors=4)
    assert net.support_dataset is other and net.support_eval.n_neighbors == 4
    assert not hasattr(net.support_eval, "full_feat")
    net.precompute()
    assert len(net.support_eval.full_y) == 12
    fresh = _port_net(variables, dataset=other, return_mask=True, n_shot_full=3, n_neighbors=4,
                      env_array=None)
    fresh.precompute()
    for mode in ("full", "knn", "ensemble"):
        torch.testing.assert_close(net.predict(x, mode)[0], fresh.predict(x, mode)[0],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The sharded ensemble and knn
# ---------------------------------------------------------------------------

def _ensemble_banks(rng, E=3, S_pad=24, D=16, C=5, B=8):
    lens = (24, 17, 9)[:E]
    feat = rng.standard_normal((E, S_pad, D)).astype(np.float32)
    y = rng.integers(0, C, (E, S_pad)).astype(np.int32)
    mask = np.zeros((E, S_pad), np.float32)
    for e, n in enumerate(lens):
        mask[e, :n] = 1.0
        feat[e, n:] = 0.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    return feat, y, mask, q


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_ensemble_matches_jax(mesh_shape):
    """Three environments of 24, 17 and 9 rows padded to 24, each split
    over the support axis (padding masked); against JAX's and the port's
    unsharded per-environment loop."""
    jax, jnp = _jax()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nwhead_tpu.parallel import make_mesh as j_make_mesh
    from nwhead_tpu.parallel import sharded_ensemble_predict_fn as j_ensemble

    feat, y, mask, q = _ensemble_banks(np.random.default_rng(sum(mesh_shape)))
    jmesh = j_make_mesh(*mesh_shape)
    shard = NamedSharding(jmesh, P(None, "support"))
    want = np.asarray(j_ensemble(jmesh, *(jax.device_put(jnp.asarray(a), shard)
                                          for a in (feat, y, mask)), 5)(
        jax.device_put(jnp.asarray(q), NamedSharding(jmesh, P("data")))))
    fn = sharded_ensemble_predict_fn(make_mesh(*mesh_shape, devices=CPU8),
                                     torch.from_numpy(feat), torch.from_numpy(y),
                                     torch.from_numpy(mask), 5)
    got = fn(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=SHARD_TOL, atol=SHARD_TOL)
    qt = torch.from_numpy(q)
    total = sum(torch.exp(tnw.nw_log_probs(qt, torch.from_numpy(feat[e]), torch.from_numpy(y[e]),
                                           5, support_mask=torch.from_numpy(mask[e])))
                for e in range(3))
    torch.testing.assert_close(got, torch.log(total / 3), rtol=SHARD_TOL, atol=SHARD_TOL)


@pytest.mark.parametrize("kernel", ["euclidean", "cosine"])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_knn_matches_jax(mesh_shape, kernel):
    """Queries near a few bank rows, so the union holds duplicates: against
    JAX's sharded knn and the port's single-device composition (exact k-NN,
    then the head over the union). The search is L2 whatever the kernel."""
    jax, jnp = _jax()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nwhead_tpu.parallel import make_mesh as j_make_mesh
    from nwhead_tpu.parallel import sharded_knn_predict_fn as j_knn

    rng = np.random.default_rng(3)
    C, S, D, B, k = 4, 64, 16, 8, 3
    feats = rng.standard_normal((S, D)).astype(np.float32)
    labels = rng.integers(0, C, S).astype(np.int32)
    q = (feats[rng.integers(0, 12, B)] + 0.01 * rng.standard_normal((B, D))).astype(np.float32)
    jmesh = j_make_mesh(*mesh_shape)
    shard = NamedSharding(jmesh, P("support"))
    want = np.asarray(j_knn(jmesh, *(jax.device_put(jnp.asarray(a), shard) for a in (
        feats, labels, np.ones(S, np.float32))), C, k, kernel=kernel)(
        jax.device_put(jnp.asarray(q), NamedSharding(jmesh, P("data")))))
    fn = sharded_knn_predict_fn(make_mesh(*mesh_shape, devices=CPU8), torch.from_numpy(feats),
                                torch.from_numpy(labels), torch.ones(S), C, k, kernel=kernel)
    got = fn(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=SHARD_TOL, atol=SHARD_TOL)
    sf, sy = tknn.ExactKNN(torch.from_numpy(feats), torch.from_numpy(labels), k)(
        torch.from_numpy(q))
    torch.testing.assert_close(got, tnw.nw_log_probs(torch.from_numpy(q), sf, sy, C, kernel=kernel),
                               rtol=SHARD_TOL, atol=SHARD_TOL)


def test_sharded_knn_masked_rows_never_enter_the_union():
    """k = 8 over 6 valid rows on two shards: each shard fills its
    candidates with masked rows at -inf, and none reaches the union (their
    label 0 keeps the log floor)."""
    rng = np.random.default_rng(4)
    D, k = 8, 8
    feats, labels, mask = np.zeros((16, D), np.float32), np.zeros(16, np.int32), np.zeros(16)
    for i, row in enumerate([1, 3, 5, 8, 10, 12]):
        feats[row] = rng.standard_normal(D)
        labels[row] = 1 + i % 3
        mask[row] = 1.0
    fn = sharded_knn_predict_fn(make_mesh(1, 2, devices=CPU8[:2]), torch.from_numpy(feats),
                                torch.from_numpy(labels), torch.from_numpy(mask), 4, k)
    out = fn(torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32)))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out[:, 0].numpy(), np.log(1e-12), rtol=1e-6)
    np.testing.assert_allclose(torch.exp(out).sum(1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="n_neighbors=9"):
        sharded_knn_predict_fn(make_mesh(1, 2, devices=CPU8[:2]), torch.from_numpy(feats),
                               torch.from_numpy(labels), torch.from_numpy(mask), 4, 9)


class _Tiny(nn.Module):
    """A linear featurizer: 8 x 8 x 3 images to 16 features."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8 * 8 * 3, 16)
        with torch.no_grad():
            self.fc.weight.copy_(torch.randn(16, 192, generator=torch.Generator().manual_seed(0))
                                 * 0.2)
            self.fc.bias.zero_()

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1))


def test_nwnet_mesh_ensemble_and_knn_match_unsharded():
    """Under a (2, 4) mesh of CPU devices (raw shards), ensemble goes
    through each environment's shards and knn through the sharded search;
    both equal the unsharded net, and a new precompute drops their caches."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=60, n_classes=4, size=8, seed=0)
    env = np.random.default_rng(0).integers(0, 3, 60)
    nets = [NWNet(copy.deepcopy(_Tiny()), 4, support_dataset=ds, device="cpu", n_shot_full=5,
                  n_neighbors=3, env_array=env, train_type="irm", mesh=mesh)
            for mesh in (make_mesh(2, 4, devices=CPU8), None)]
    for net in nets:
        net.precompute()
    sharded, alone = nets
    # Queries off the bank: a query that is a bank row scores sqrt of
    # rounding residue, which differs between a shard and the whole bank.
    x = make_synthetic_dataset(n=8, n_classes=4, size=8, seed=1).gather(np.arange(8))
    for mode, cache in (("ensemble", "_sharded_ensemble_cache"), ("knn", "_sharded_knn_cache")):
        torch.testing.assert_close(sharded.predict(x, mode), alone.predict(x, mode),
                                   rtol=SHARD_TOL, atol=SHARD_TOL)
        assert getattr(sharded, cache) is not None and getattr(alone, cache) is None
    sharded.precompute()
    assert sharded._sharded_knn_cache is None and sharded._sharded_ensemble_cache is None


def test_trainer_evaluates_the_retrieval_modes():
    """``NWTrainer(eval_modes=...)`` takes ensemble, knn and hnsw (the JAX
    IRM protocol evaluates full and ensemble): each pass over the
    validation set (its tail batch padded with row 0) gives finite metrics."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.train.trainer import NWTrainer

    train = make_synthetic_dataset(n=36, n_classes=4, size=8, seed=0)
    val = make_synthetic_dataset(n=10, n_classes=4, size=8, seed=1)
    net = NWNet(_Tiny(), 4, support_dataset=train, device="cpu", n_neighbors=3,
                train_type="irm", env_array=np.arange(36) % 2)
    trainer = NWTrainer(net, train, val, batch_size=4, eval_modes=("ensemble", "knn", "hnsw"))
    trainer.eval_all_modes()
    for mode in ("ensemble", "knn", "hnsw"):
        for name in ("loss", "acc", "ece"):
            assert np.isfinite(trainer.val_metrics[f"{name}:val:{mode}"].result())


# ---------------------------------------------------------------------------
# On the card (gpu): K1 and K1 partials on the modes' shapes
# ---------------------------------------------------------------------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ensemble_and_knn_through_k1():
    """Three environment banks of 800 rows with padding masked, the head
    over each through K1 against the plain head; the knn union of B = 64
    queries at k = 20 (1,280 rows) through K1; the ids against a CPU stable
    sort of the same distances."""
    from nwhead_tpu_torch.nw.head import NWHead

    dev = _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    B, S, D, C = 64, 800, 512, 200
    head = NWHead(C, fused_min_support=512).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    for n in (600, 800):
        f = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, C, S)).to(dev)
        m = (torch.arange(S, device=dev) < n).to(torch.float32)
        before = tfused.nw_fwd_cuda.launches
        got = head(q, f, y, m)
        assert tfused.nw_fwd_cuda.launches == before + 1
        torch.testing.assert_close(got, tnw.nw_log_probs(q, f, y, C, support_mask=m),
                                   rtol=2e-4, atol=2e-4)
    bank = torch.from_numpy(rng.standard_normal((2000, D), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, C, 2000)).to(dev)
    knn = tknn.ExactKNN(bank, labels, 20)
    ids = knn.indices(q)
    d2 = tknn.pairwise_sqdist(q.cpu(), bank.cpu())
    torch.testing.assert_close(ids.cpu(), torch.sort(d2, dim=1, stable=True)[1][:, :20])
    sf, sy = knn(q)
    before = tfused.nw_fwd_cuda.launches
    got = head(q, sf, sy)
    assert tfused.nw_fwd_cuda.launches == before + 1
    torch.testing.assert_close(got, tnw.nw_log_probs(q, sf, sy, C), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_sharded_ensemble_and_knn_on_one_card():
    """Four shards on one card: the sharded ensemble launches K1 partials
    shards x environments times and equals the unsharded loop; the sharded
    knn equals the single-device composition."""
    dev = _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    feat, y, mask, q = _ensemble_banks(rng, S_pad=800, D=512, C=200, B=64)
    mask[1, 500:] = 0.0
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    fn = sharded_ensemble_predict_fn(mesh, *(torch.from_numpy(a).to(dev)
                                             for a in (feat, y, mask)), 200)
    qd = torch.from_numpy(q).to(dev)
    before = tfused.nw_fwd_partials_cuda.launches
    got = fn(qd)
    assert tfused.nw_fwd_partials_cuda.launches == before + 4 * 3
    total = sum(torch.exp(tnw.nw_log_probs(qd, *(torch.from_numpy(a[e]).to(dev)
                                                 for a in (feat, y)), 200,
                                           support_mask=torch.from_numpy(mask[e]).to(dev)))
                for e in range(3))
    torch.testing.assert_close(got, torch.log(total / 3), rtol=2e-4, atol=2e-4)
    bank = torch.from_numpy(feat[0]).to(dev)
    labels = torch.from_numpy(y[0]).to(dev)
    knn_fn = sharded_knn_predict_fn(mesh, bank, labels, torch.ones(800, device=dev), 200, 20)
    sf, sy = tknn.ExactKNN(bank, labels, 20)(qd)
    torch.testing.assert_close(knn_fn(qd), tnw.nw_log_probs(qd, sf, sy, 200),
                               rtol=2e-4, atol=2e-4)
