"""Bank edits of the port against the JAX package: ``prepare_for_concat``,
``concat_prepared`` and ``mask_prepared_rows`` (``ops/fused_nw.py``),
``concat_ivf`` (``ops/ivf.py``), ``SupportSetEval.extend_bank`` /
``remove_bank_items`` (``nw/support.py``), ``NWNet.add_support`` /
``remove_support`` / ``restore_bank`` (``nw/net.py``) and
``ShardedSupportBank.remove_rows`` with its row map
(``parallel/sharded_bank.py``).

The same numpy inputs go to both packages. JAX's prepared head runs its
Pallas kernel in interpret mode; the port's runs its plain version.
Log-probs agree within 1e-4 (``TOL``) after every edit, and an edited
bank agrees with one prepared whole over the same rows (or a
``restore_bank`` of them). The nets are ResNet-10 on a flax tree filled
from numpy (no init is compiled) and carried to the port by
``models/convert.py``; every JAX net shares one jitted featurizer, so that
the featurizer compiles once.

The CUDA routes (K2/K4/K5/K6 and their ``partials`` over edited banks) are
tested on the card only (marker ``gpu``): ``python -m pytest --noconftest
-m gpu tests/test_torch_bank_edits.py``. That machine has no jax, so this
module imports the JAX package inside the tests that compare with it.
"""

import functools

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops import ivf as tivf
from nwhead_tpu_torch.parallel import ShardedSupportBank, make_mesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
PRECISIONS = ("f32", "bf16", "int8", "int4")
# (C, kernel) of the op tests: C <= 128 keeps input order, C = 200 sorts by class.
CASES = ((4, "euclidean"), (200, "euclidean"), (4, "cosine"), (200, "dotproduct"))
# The case each precision is also held to JAX on (one interpret-mode head each).
JAX_CASE = {"f32": 1, "bf16": 2, "int8": 3, "int4": 0}
MESHES = ((1, 8), (2, 4), (4, 2))
CPU8 = [torch.device("cpu")] * 8


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _rows(S, D, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, D)).astype(np.float32),
            rng.integers(0, C, S).astype(np.int32),
            rng.standard_normal((6, D)).astype(np.float32))


def _head(q, prep, C, kernel):
    return tfused.nw_fused_from_prepared(torch.from_numpy(q), prep, C, kernel=kernel)


def _jax_head(q, jprep, C, kernel):
    _, jnp = _jax()
    from nwhead_tpu.ops.pallas_nw import nw_fused_from_prepared

    return np.asarray(nw_fused_from_prepared(jnp.asarray(q), jprep, C, kernel=kernel))


JAX_CUTS = (0, 96, 240, 300)


def _jax_parts(f, y, C, kernel, precision):
    """JAX's parts of rows ``JAX_CUTS``, at 128-row tiles
    (``prepare_for_concat``), and each input row's position in their
    concatenation."""
    _, jnp = _jax()
    from nwhead_tpu.ops import pallas_nw as jfused

    parts, pos, base = [], [], 0
    for a, b in zip(JAX_CUTS, JAX_CUTS[1:]):
        args = (jnp.asarray(f[a:b]), jnp.asarray(y[a:b]), C)
        kw = dict(kernel=kernel, precision=precision, return_order=True)
        p, o = (jfused.prepare_support(*args, block_s=128, **kw) if not parts
                else jfused.prepare_for_concat(*args, parts[0], **kw))
        parts.append(p)
        pos.append(base + (np.arange(b - a) if o is None else tfused.inverse_order(o)[:b - a]))
        base += np.asarray(p.lane).size
    return parts, np.concatenate(pos)


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:int4 serving banks")  # dotproduct at int4, both packages
@pytest.mark.parametrize("precision", PRECISIONS)
def test_concat_prepared_matches_whole_bank_and_jax(precision):
    """Three parts prepared apart and concatenated hold the rows, codes,
    scales and self-norms of one bank prepared whole (each row is
    prepared on its own), in every case; log-probs equal the whole bank's
    and, on one case, JAX's ``concat_prepared`` of its parts."""
    cuts = JAX_CUTS
    for i, (C, kernel) in enumerate(CASES):
        f, y, q = _rows(300, 24, C, seed=i)
        parts, orders = [], []
        for a, b in zip(cuts, cuts[1:]):
            p, o = tfused.prepare_support(torch.from_numpy(f[a:b]), y[a:b], C, kernel=kernel,
                                          precision=precision, return_order=True)
            parts.append(p)
            orders.append(np.arange(b - a) if o is None else o)
        cat = tfused.concat_prepared(parts)
        whole, worder = tfused.prepare_support(torch.from_numpy(f), y, C, kernel=kernel,
                                               precision=precision, return_order=True)
        # Input row of each concatenated row, and where the whole bank holds it.
        src = np.concatenate([a + o for a, o in zip(cuts, orders)])
        at = src if worder is None else tfused.inverse_order(worder)[src]
        for field in ("s", "s2", "labels", "sscale"):
            got, want = getattr(cat, field), getattr(whole, field)
            assert (got is None) == (want is None), field
            if got is not None:
                assert torch.equal(got, want[torch.from_numpy(at)]), (C, kernel, field)
        out = _head(q, cat, C, kernel)
        torch.testing.assert_close(out, _head(q, whole, C, kernel), **TOL)
        if i == JAX_CASE[precision]:
            from nwhead_tpu.ops import pallas_nw as jfused

            jbank = jfused.concat_prepared(_jax_parts(f, y, C, kernel, precision)[0], C)
            np.testing.assert_allclose(out.numpy(), _jax_head(q, jbank, C, kernel), **TOL)


@pytest.mark.filterwarnings("ignore:int4 serving banks")
@pytest.mark.parametrize("precision", PRECISIONS)
def test_mask_prepared_rows_equals_masked_prepare(precision):
    """Rows tombstoned by their prepared positions (``return_order``)
    serve as a bank prepared with those rows masked, and as JAX's
    tombstoned bank on one case; the bank given stays as it was."""
    for i, (C, kernel) in enumerate(CASES):
        f, y, q = _rows(300, 24, C, seed=10 + i)
        drop = np.random.default_rng(i).permutation(300)[:70]
        prep, order = tfused.prepare_support(torch.from_numpy(f), y, C, kernel=kernel,
                                             precision=precision, return_order=True)
        before = {k: None if v is None else v.clone() for k, v in prep._asdict().items()
                  if isinstance(v, torch.Tensor) or v is None}
        pos = np.arange(300) if order is None else tfused.inverse_order(order)
        masked = tfused.mask_prepared_rows(prep, pos[drop])
        for k, v in before.items():
            assert v is None or torch.equal(getattr(prep, k), v), k
        assert masked.s is prep.s and masked.sscale is prep.sscale
        assert int((masked.labels < 0).sum()) == 70
        if masked.s2 is not None:
            assert bool((masked.s2[torch.from_numpy(pos[drop])] == 1e30).all())
        mask = np.ones(300, np.float32)
        mask[drop] = 0.0
        oracle = tfused.prepare_support(torch.from_numpy(f), y, C, kernel=kernel,
                                        precision=precision, support_mask=torch.from_numpy(mask))
        out = _head(q, masked, C, kernel)
        torch.testing.assert_close(out, _head(q, oracle, C, kernel), **TOL)
        if order is None:  # rows in place: the same labels exactly
            assert torch.equal(masked.labels, oracle.labels)
        if i == JAX_CASE[precision]:
            # JAX's tombstones on its concatenated bank of the concat test's
            # parts (the same shapes: its head compiles once).
            jparts, jpos = _jax_parts(f, y, C, kernel, precision)
            from nwhead_tpu.ops import pallas_nw as jfused

            jbank = jfused.mask_prepared_rows(jfused.concat_prepared(jparts, C), jpos[drop])
            np.testing.assert_allclose(out.numpy(), _jax_head(q, jbank, C, kernel), **TOL)


def test_edit_ops_refuse_what_jax_refuses():
    f, y, _ = _rows(300, 24, 7, seed=3)
    ft = torch.from_numpy(f)
    base = tfused.prepare_support(ft, y, 7)
    refused = {
        "precision": tfused.prepare_support(ft, y, 7, precision="bf16"),
        "feature width": tfused.prepare_support(ft[:, :16], y, 7),
        "block_s": tfused.prepare_support(ft, y, 7, block_s=128),
        "s2 presence": tfused.prepare_support(ft, y, 7, kernel="cosine"),
        "sscale presence": base._replace(sscale=torch.ones(300)),
    }
    for what, other in refused.items():
        with pytest.raises(ValueError, match=what):
            tfused.concat_prepared([base, other])
    with pytest.raises(ValueError, match="at least one"):
        tfused.concat_prepared([])
    assert tfused.concat_prepared([base]) is base
    assert tfused.mask_prepared_rows(base, np.array([], np.int64)) is base
    for rows in ([300], [-1]):
        with pytest.raises(IndexError):
            tfused.mask_prepared_rows(base, np.array(rows))
    with pytest.raises(ValueError, match="at least one row"):
        tfused.prepare_for_concat(ft[:0], y[:0], 7, base)
    ivf = tivf.prepare_support_ivf(ft, y, 7, block_s=128)
    narrow = tivf.prepare_support_ivf(ft[:, :16], y, 7, block_s=128)
    with pytest.raises(ValueError, match="routing width"):
        tivf.concat_ivf([ivf, narrow])
    with pytest.raises(ValueError, match="at least one"):
        tivf.concat_ivf([])


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_prepare_for_concat_pads_to_a_tiled_bank(precision):
    """A 10-row add to a bank tiled at 256 rows: ``prepare_for_concat``
    pads it with masked rows to one 256-row tile, as JAX's does; plain
    ``prepare_support`` would shrink its tile to 128 and the concat is
    refused. The grown bank serves as one prepared whole, tile by tile."""
    _, jnp = _jax()
    from nwhead_tpu.ops import pallas_nw as jfused

    f, y, q = _rows(610, 24, 200, seed=4)
    ft = torch.from_numpy(f)
    like = tfused.prepare_support(ft[:600], y[:600], 200, precision=precision, block_s=256)
    assert like.block_s == 256 and like.labels.shape[0] == 768
    inc = tfused.prepare_for_concat(ft[600:], y[600:], 200, like, precision=precision)
    assert inc.block_s == 256 and inc.labels.shape[0] == 256
    assert int((inc.labels >= 0).sum()) == 10
    jlike = jfused.prepare_support(jnp.asarray(f[:600]), jnp.asarray(y[:600]), 200,
                                   precision=precision, block_s=256)
    jinc = jfused.prepare_for_concat(jnp.asarray(f[600:]), jnp.asarray(y[600:]), 200, jlike,
                                     precision=precision)
    assert np.asarray(jinc.lane).size == 256
    with pytest.raises(ValueError, match="block_s"):
        tfused.concat_prepared([like, tfused.prepare_support(ft[600:], y[600:], 200,
                                                             precision=precision, block_s=256)])
    cat = tfused.concat_prepared([like, inc])
    whole = tfused.prepare_support(ft, y, 200, precision=precision)
    torch.testing.assert_close(_head(q, cat, 200, "euclidean"), _head(q, whole, 200, "euclidean"),
                               **TOL)
    every_tile = torch.arange(cat.labels.shape[0] // 256, dtype=torch.int32)
    torch.testing.assert_close(
        tfused.nw_fused_from_prepared(torch.from_numpy(q), cat, 200, tile_sel=every_tile),
        _head(q, whole, 200, "euclidean"), **TOL)


def test_concat_ivf_matches_jax_and_full_probe():
    """Two IVF chunks in class order (C >= tiles) joined by ``concat_ivf``:
    the routing index equals JAX's, and a probe of every tile equals the
    full pass over the joined bank and over the rows prepared whole (the
    routed head is held to JAX's in the ``NWNet`` sequences below)."""
    _, jnp = _jax()
    from nwhead_tpu.ops import ivf as jivf

    C = 8
    f, y, q = _rows(700, 24, C, seed=5)
    ft = torch.from_numpy(f)
    parts = [tivf.prepare_support_ivf(ft[a:b], y[a:b], C, block_s=128)
             for a, b in ((0, 600), (600, 700))]
    cat = tivf.concat_ivf(parts)
    assert cat.cents.shape[0] == 5 + 1 and cat.prep.labels.shape[0] == 768
    jparts = [jivf.prepare_support_ivf(jnp.asarray(f[a:b]), jnp.asarray(y[a:b]), C, block_s=128)
              for a, b in ((0, 600), (600, 700))]
    jcat = jivf.concat_ivf(jparts, C)
    np.testing.assert_allclose(cat.cents.numpy(), np.asarray(jcat.cents)[:, :24], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cat.c2.numpy(), np.asarray(jcat.c2), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cat.cvalid.numpy(), np.asarray(jcat.cvalid))
    np.testing.assert_array_equal(cat.prep.labels.numpy(),
                                  np.asarray(jcat.prep.lane).reshape(-1))
    full = tivf.nw_fused_ivf_log_probs(torch.from_numpy(q), cat, C, n_probe=6)
    torch.testing.assert_close(full, _head(q, cat.prep, C, "euclidean"), rtol=0, atol=1e-6)
    torch.testing.assert_close(full, _head(q, tfused.prepare_support(ft, y, C), C, "euclidean"),
                               **TOL)


# ---------------------------------------------------------------------------
# SupportSetEval.
# ---------------------------------------------------------------------------

def _eval_pair(seed=0):
    """JAX's and the port's ``SupportSetEval`` over the same features in
    three uneven environments, sklearn clusters (bit-identical in both)."""
    from nwhead_tpu.nw.support import SupportSetEval as JEval

    from nwhead_tpu_torch.nw.support import SupportSetEval

    rng = np.random.default_rng(seed)
    y = np.tile(np.arange(4), 10)
    env = np.sort(rng.choice(3, 40, p=[0.5, 0.3, 0.2]))
    f = rng.standard_normal((40, 16)).astype(np.float32)
    kw = dict(n_shot_full=100, n_shot_cluster=2, n_neighbors=3, env_array=env, seed=0,
              cluster_impl="sklearn")
    jse, tse = JEval(y, 4, **kw), SupportSetEval(y, 4, **kw)
    envs = [e for e in range(3)]
    segs = [np.nonzero(env == e)[0] for e in envs]
    jse.build_infer_iters(f, y, env, [f[s] for s in segs], [y[s] for s in segs],
                          [env[s] for s in segs])
    full = torch.from_numpy(f)
    tse.build_infer_iters(full, y, env, list(full.split([len(s) for s in segs])),
                          [y[s] for s in segs], [env[s] for s in segs])
    return jse, tse, rng


def _assert_same_eval(jse, tse, x):
    np.testing.assert_array_equal(tse.full_feat.numpy(), np.asarray(jse.full_feat))
    np.testing.assert_array_equal(tse.full_y.numpy(), np.asarray(jse.full_y))
    np.testing.assert_array_equal(tse.full_meta, jse.full_meta)
    assert len(tse.full_feat_sep) == len(jse.full_feat_sep)
    for tf, jf, ty, jy in zip(tse.full_feat_sep, jse.full_feat_sep, tse.full_y_sep,
                              jse.full_y_sep):
        assert tf.data_ptr() >= tse.full_feat.data_ptr()  # a view of the one bank
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tse.random_sampler.sample()[0], jse.random_sampler.sample()[0])
    tf, ty = tse.knn(torch.from_numpy(x))
    jf, jy = jse.knn(x)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tse.cluster_feat.numpy(), np.asarray(jse.cluster_feat), rtol=0,
                               atol=1e-6)


def test_support_eval_edits_match_jax():
    """Adds to an environment mid-bank and to a new one, removals across
    environments, an environment emptied and dropped: after each, the same
    bank, environment lists (views of the bank), sampler indices, knn
    union and clusters as JAX's."""
    jse, tse, rng = _eval_pair()
    x = rng.standard_normal((5, 16)).astype(np.float32)
    _assert_same_eval(jse, tse, x)
    edits = [("add", 1, 6), ("add", 7, 4), ("remove", None, [0, 5, 21, 33, 40, 47]),
             ("add", 0, 3)]
    for kind, env_id, arg in edits:
        if kind == "add":
            nf = rng.standard_normal((arg, 16)).astype(np.float32)
            ny = rng.integers(0, 4, arg)
            jse.extend_bank(nf, ny, env_id=env_id)
            tse.extend_bank(torch.from_numpy(nf), ny, env_id=env_id)
        else:
            jse.remove_bank_items(arg)
            tse.remove_bank_items(arg)
        assert tse.bank_is_canonical is jse.bank_is_canonical is False
        _assert_same_eval(jse, tse, x)
    # Empty environment 7 (its rows end the bank after the adds): dropped.
    last = np.nonzero(tse.full_meta == 7)[0]
    jse.remove_bank_items(last)
    tse.remove_bank_items(last)
    assert 7 not in [int(m[0]) for m in tse.full_meta_sep]
    _assert_same_eval(jse, tse, x)


def test_support_eval_hnsw_grows_and_drops():
    """A built graph grows by ``add_items`` (the same object; its ids on the
    same queries equal JAX's graph's), an unbuilt one stays unbuilt, a
    failed install leaves the graph as it was, a removal drops it."""
    jse, tse, rng = _eval_pair(seed=1)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    graph = tse.hnsw
    nf = rng.standard_normal((6, 16)).astype(np.float32)
    ny = rng.integers(0, 4, 6)
    tse.extend_bank(torch.from_numpy(nf), ny, env_id=1)
    jse.extend_bank(nf, ny, env_id=1)
    assert tse.hnsw is graph and len(graph) == 46
    np.testing.assert_array_equal(graph.knn_query(x, k=5), jse.hnsw.knn_query(x, k=5))
    np.testing.assert_array_equal(graph.data[-6:].numpy(), nf)

    import nwhead_tpu_torch.nw.support as tsupport

    real = tsupport.compute_clusters
    tsupport.compute_clusters = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("no room"))
    try:
        with pytest.raises(RuntimeError, match="no room"):
            tse.extend_bank(torch.from_numpy(nf), ny)
    finally:
        tsupport.compute_clusters = real
    assert len(graph) == len(tse.full_y) == 46
    tse.remove_bank_items([0])
    assert tse._hnsw is None and len(tse.hnsw) == 45
    tse.remove_bank_items([1])
    tse.extend_bank(torch.from_numpy(nf), ny)
    assert tse._hnsw is None


def test_support_eval_edit_refusals():
    from nwhead_tpu_torch.nw.support import SupportSetEval

    fresh = SupportSetEval(np.arange(8) % 4, 4)
    with pytest.raises(AttributeError, match="precompute"):
        fresh.extend_bank(torch.zeros(1, 16), np.zeros(1))
    with pytest.raises(AttributeError, match="precompute"):
        fresh.remove_bank_items([0])
    _, tse, _ = _eval_pair()
    with pytest.raises(ValueError, match="labels"):
        tse.extend_bank(torch.zeros(2, 16), np.zeros(3))
    for bad in ([40], [-1]):
        with pytest.raises(IndexError):
            tse.remove_bank_items(bad)
    with pytest.raises(ValueError, match="every support item"):
        tse.remove_bank_items(np.arange(40))
    assert len(tse.full_y) == 40


# ---------------------------------------------------------------------------
# NWNet.
# ---------------------------------------------------------------------------

NET_KW = dict(n_shot_full=12, n_shot_cluster=2, n_neighbors=3, fused_min_support=32,
              precompute_batch=16, cluster_impl="sklearn", seed=0, ivf_n_probe=1)


@functools.lru_cache(maxsize=None)
def _resnet10():
    """JAX's ResNet-10, a filled tree of it, and one jitted eval forward
    that every JAX net of this module shares."""
    jax, jnp = _jax()
    from nwhead_tpu.models import load_model as jload

    model = jload("resnet10")
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((2, 16, 16, 3), jnp.float32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_out = int(np.prod(s.shape[:2])) * s.shape[-1]
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return (rng.random(s.shape) + 0.5).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    variables = {"params": {"featurizer": tree["params"]},
                 "batch_stats": {"featurizer": tree["batch_stats"]}}
    forward = jax.jit(lambda v, x: model.apply(
        {"params": v["params"]["featurizer"], "batch_stats": v["batch_stats"]["featurizer"]},
        x, train=False))
    return model, variables, forward


def _datasets(n=48):
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset

    return (make_synthetic_dataset(n=n, n_classes=4, size=16, seed=0),
            make_synthetic_dataset(n=40, n_classes=4, size=16, seed=11),
            make_synthetic_dataset(n=8, n_classes=4, size=16, seed=3).images)


def _port_net(ds, **kw):
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
    from nwhead_tpu_torch.nw.net import NWNet

    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=ds, device="cpu",
                **{**NET_KW, **kw})
    net.model.load_state_dict(jax_to_torch_nwmodel(_resnet10()[1]))
    return net


def _jax_net(ds, **kw):
    from nwhead_tpu.nw.net import NWNet as JNet

    model, variables, forward = _resnet10()
    net = JNet(model, 4, support_dataset=ds, **{**NET_KW, **kw})
    net._featurize_eval = forward
    return net, variables


def _ledger_edits(seed, pool, n0):
    """A seeded sequence of five edits: adds of 3 pool images or removals
    of 2 random rows, as ``tests/test_incremental_bank.py`` draws them."""
    rng = np.random.default_rng(seed)
    n, at, edits = n0, 0, []
    for _ in range(5):
        if rng.integers(2) == 0 and at + 3 <= len(pool.targets):
            edits.append(("add", np.arange(at, at + 3)))
            at, n = at + 3, n + 3
        else:
            drop = np.sort(rng.choice(n, size=2, replace=False))
            edits.append(("remove", drop))
            n -= 2
    return edits


def _apply(net, edits, pool, variables=None):
    for kind, arg in edits:
        args = () if variables is None else (variables,)
        if kind == "add":
            net.add_support(*args, pool.images[arg], pool.targets[arg])
        else:
            net.remove_support(*args, arg)


def _oracle(ds, net, **kw):
    """A port net with the edited net's bank installed by ``restore_bank``."""
    fresh = _port_net(ds, **kw)
    fresh.restore_bank(net.full_feat, net.full_y, meta=net.support_eval.full_meta)
    return fresh


def test_add_support_equals_a_fresh_precompute():
    """Eight added images: full and knn log-probs as a net precomputed over
    the union; the prepared bank grew by the new rows alone."""
    from nwhead_tpu_torch.data.datasets import ArrayDataset

    ds, pool, x = _datasets()
    net = _port_net(ds)
    net.precompute()
    old = net._prepared_full
    assert net.support_eval.bank_is_canonical
    net.add_support(pool.images[:8], pool.targets[:8])
    assert not net.support_eval.bank_is_canonical
    grown = net._prepared_full
    assert grown.labels.shape[0] == 56 and torch.equal(grown.s[:48], old.s)
    union = ArrayDataset(np.concatenate([ds.images, pool.images[:8]]),
                         np.concatenate([ds.targets, pool.targets[:8]]), num_classes=4)
    fresh = _port_net(union, n_shot_full=14)
    fresh.precompute()
    np.testing.assert_array_equal(np.sort(fresh.full_feat.numpy(), 0),
                                  np.sort(net.full_feat.numpy(), 0))
    for mode in ("full", "knn"):
        torch.testing.assert_close(net.predict(x, mode), fresh.predict(x, mode), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_sequences_match_restore_and_jax(seed):
    """Five seeded edits: full and knn log-probs as a ``restore_bank`` of
    the rows left, and full, knn and ivf (its bank grown by ``concat_ivf``,
    routed at one probe) as JAX's net after the same edits."""
    ds, pool, x = _datasets()
    net = _port_net(ds)
    net.precompute()
    net._ivf_bank()  # built now, so that the adds grow it
    jnet, variables = _jax_net(ds)
    jnet.precompute(variables)
    jnet._ivf_bank()
    edits = _ledger_edits(seed, pool, 48)
    _apply(net, edits, pool)
    _apply(jnet, edits, pool, variables)
    np.testing.assert_allclose(net.full_feat.numpy(), np.asarray(jnet.full_feat), rtol=1e-5,
                               atol=1e-5)
    oracle = _oracle(ds, net)
    for mode in ("full", "knn", "ivf"):
        got = net.predict(x, mode)
        if mode != "ivf":  # a fresh IVF bank has other tiles than a grown one
            torch.testing.assert_close(got, oracle.predict(x, mode), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnet.predict(variables, x, mode)),
                                   **TOL, err_msg=mode)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_quantized_edit_sequence_matches_restore_and_jax(precision):
    """Edits on a bf16, int8 or int4 prepared bank: full-mode log-probs as
    a ``restore_bank`` of the rows left (each row quantized on its own) and
    as JAX's net after the same edits."""
    ds, pool, x = _datasets()
    net = _port_net(ds, head_precision=precision)
    net.precompute()
    jnet, variables = _jax_net(ds, head_precision=precision)
    jnet.precompute(variables)
    edits = [("add", np.arange(3)), ("remove", np.array([2, 30])), ("add", np.arange(3, 6)),
             ("remove", np.array([0, 49]))]
    _apply(net, edits, pool)
    _apply(jnet, edits, pool, variables)
    assert net._prepared_dead == 4
    got = net.predict(x, "full")
    torch.testing.assert_close(got, _oracle(ds, net, head_precision=precision).predict(x, "full"),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.predict(variables, x, "full")), **TOL)


def _count_prepares(monkeypatch):
    import nwhead_tpu_torch.nw.net as tnet

    calls = []
    real = tnet.prepare_support
    monkeypatch.setattr(tnet, "prepare_support",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_remove_support_tombstones_then_compacts_where_jax_does(monkeypatch):
    """On a 128-row bank, JAX's one tile and the port's own row count
    agree: 20 and then 12 rows are tombstoned (32 dead = 25%: no prepare),
    one more compacts (one whole prepare), in both packages; the prepared
    features stay the same tensor until then, and each bank serves as a
    ``restore_bank`` of its rows."""
    ds, _, x = _datasets(n=160)
    net = _port_net(ds, n_shot_full=32)
    net.precompute()
    jnet, variables = _jax_net(ds, n_shot_full=32)
    jnet.precompute(variables)
    assert net._prepared_full.labels.shape[0] == 128
    s = net._prepared_full.s
    calls = _count_prepares(monkeypatch)
    for drop, dead, n_calls in ((np.arange(0, 40, 2), 20, 0), (np.arange(12) * 5, 32, 0),
                                (np.array([7]), 0, 1)):
        net.remove_support(drop)
        jnet.remove_support(variables, drop)
        assert net._prepared_dead == jnet._prepared_dead == dead
        assert len(calls) == n_calls and len(net._prepared_pos) == len(net.full_y)
        assert (net._prepared_full.s is s) == (n_calls == 0)
        torch.testing.assert_close(net.predict(x, "full"), _oracle(ds, net, n_shot_full=32)
                                   .predict(x, "full"), **TOL)
        calls.clear()  # the oracle's own prepare


def test_add_then_remove_restores_the_bank():
    """Adding eight rows and removing them again (tombstones) leaves the
    live rows, their order and the log-probs as before."""
    ds, pool, x = _datasets()
    net = _port_net(ds)
    net.precompute()
    before, prep = net.predict(x, "full"), net._prepared_full
    net.add_support(pool.images[:8], pool.targets[:8])
    assert not torch.allclose(net.predict(x, "full"), before)
    net.remove_support(np.arange(48, 56))
    live = net._prepared_full.labels >= 0
    assert torch.equal(net._prepared_full.s[live], prep.s)
    assert torch.equal(net._prepared_full.labels[live], prep.labels)
    torch.testing.assert_close(net.predict(x, "full"), before, rtol=0, atol=1e-6)


def test_serving_fn_serves_the_live_bank_and_fails_loudly():
    """A callable made before the edits serves each edited bank, and raises
    once removals take the bank below ``fused_min_support``."""
    ds, pool, x = _datasets()
    net = _port_net(ds, fused_min_support=48)
    net.precompute()
    serve = net.make_serving_fn()
    first = serve(x)
    net.add_support(pool.images[:4], pool.targets[:4])
    after = serve(x)
    assert not torch.allclose(first, after)
    torch.testing.assert_close(after, net.predict(x, "full"), rtol=0, atol=0)
    net.remove_support(np.arange(10))
    assert net._prepared_full is None
    with pytest.raises(ValueError, match="prepared serving bank"):
        serve(x)


def test_ivf_bank_grows_by_concat_ivf(monkeypatch):
    """With an IVF bank built, an add prepares a chunk of the new rows
    (padded to the bank's tile) and joins it by ``concat_ivf``: no rebuild
    at the next ivf call, the cache keyed on the grown bank, every tile
    probed equal to full mode; a removal drops it for a rebuild."""
    import nwhead_tpu_torch.nw.net as tnet

    ds, pool, x = _datasets()
    net = _port_net(ds, ivf_n_probe=10_000)
    net.precompute()
    net.predict(x, "ivf")
    calls = {"concat_ivf": [], "prepare_support_ivf": []}
    for name in calls:
        real = getattr(tnet, name)
        monkeypatch.setattr(tnet, name, lambda *a, _r=real, _n=name, **k:
                            calls[_n].append(1) or _r(*a, **k))
    net.add_support(pool.images[:5], pool.targets[:5])
    net.add_support(pool.images[5:8], pool.targets[5:8], env_id=3)
    ivf = net._ivf_bank()
    assert len(calls["concat_ivf"]) == len(calls["prepare_support_ivf"]) == 2
    assert net._ivf_cache[0] is net.full_feat and ivf.cents.shape[0] == 3
    assert ivf.prep.labels.shape[0] == 3 * 128
    full = net.predict(x, "full")
    torch.testing.assert_close(net.predict(x, "ivf"), full, rtol=0, atol=1e-6)
    net.remove_support([0])
    assert net._ivf_cache is None
    torch.testing.assert_close(net.predict(x, "ivf"), net.predict(x, "full"), rtol=0, atol=1e-6)
    assert len(calls["prepare_support_ivf"]) == 3


def test_environment_edits_restore_bank_and_refusals():
    """Adds to a new environment and mid-bank to an old one; the new one
    emptied and dropped (the ensemble stays finite); ``restore_bank``
    groups rows by environment; labels, indices and sizes out of range
    raise; every edit checks the serving featurizer first."""
    ds, pool, x = _datasets()
    net = _port_net(ds)
    net.precompute()
    net.add_support(pool.images[:8], pool.targets[:8], env_id=1)
    net.add_support(pool.images[8:12], pool.targets[8:12], env_id=0)
    assert net.support_eval.full_meta[48:52].tolist() == [0] * 4
    assert net.support_eval.full_meta[52:].tolist() == [1] * 8
    assert torch.isfinite(net.predict(x, "ensemble")).all()
    oracle = _oracle(ds, net)
    torch.testing.assert_close(net.predict(x, "full"), oracle.predict(x, "full"), **TOL)
    net.remove_support(np.arange(52, 60))
    assert len(net.support_eval.full_feat_sep) == 1
    assert torch.isfinite(net.predict(x, "ensemble")).all()
    with pytest.raises(ValueError, match="labels"):
        net.add_support(pool.images[:2], np.array([0, 4]))
    with pytest.raises(IndexError):
        net.remove_support([10_000])
    with pytest.raises(ValueError, match="every support item"):
        net.remove_support(np.arange(len(net.full_y)))
    with pytest.raises(ValueError, match="size mismatch"):
        net.restore_bank(net.full_feat, net.full_y[:-1])
    meta = np.array([2, 0, 2, 1] * 13)[:52]
    net.restore_bank(net.full_feat, net.full_y, meta=meta)
    assert [int(m[0]) for m in net.support_eval.full_meta_sep] == [2, 0, 1]
    assert net.support_eval.bank_is_canonical

    def stale():
        raise RuntimeError("stale serving featurizer")

    net._check_serving_source = stale
    for edit in (lambda: net.add_support(pool.images[:1], pool.targets[:1]),
                 lambda: net.remove_support([0]),
                 lambda: net.restore_bank(net.full_feat, net.full_y)):
        with pytest.raises(RuntimeError, match="stale"):
            edit()


# ---------------------------------------------------------------------------
# The sharded bank.
# ---------------------------------------------------------------------------

def _sharded_rows(S=600, D=32, C=7, B=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, D)).astype(np.float32),
            rng.integers(0, C, S).astype(np.int32), rng.standard_normal((B, D)).astype(np.float32))


def _chained_drops(S, seed):
    rng = np.random.default_rng(seed)
    live, drops = np.arange(S), []
    for n in (80, 40):
        drop = np.unique(rng.permutation(len(live))[:n])
        drops.append(drop)
        live = np.delete(live, drop)
    return drops, live


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_remove_rows_raw_matches_jax_and_a_rebuilt_bank(mesh_shape):
    """Two chained removals from raw shards (600 rows: padding on the last
    shard): the row map and log-probs equal JAX's bank after the same
    removals on its eight virtual devices, and a bank built over the rows
    left; shapes and every untouched shard stay as they were."""
    jax, jnp = _jax()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nwhead_tpu.parallel import ShardedSupportBank as JBank
    from nwhead_tpu.parallel import make_mesh as jmesh

    f, y, q = _sharded_rows()
    mesh, jm = make_mesh(*mesh_shape, devices=CPU8), jmesh(*mesh_shape)
    bank = ShardedSupportBank.build(torch.from_numpy(f), y, mesh, 7, use_prepared=False)
    jbank = JBank.build(f, y, jm, 7, use_prepared=False)
    np.testing.assert_array_equal(bank.rowmap, jbank.rowmap)
    drops, live = _chained_drops(600, seed=mesh_shape[0])
    for drop in drops:
        new = bank.remove_rows(drop)
        assert new.capacity == bank.capacity and bank.dead == new.dead - len(drop)
        bank, jbank = new, jbank.remove_rows(drop)
        np.testing.assert_array_equal(bank.rowmap, jbank.rowmap)
    got = bank.predict_fn()(torch.from_numpy(q))
    want = jbank.predict_fn()(jax.device_put(jnp.asarray(q), NamedSharding(jm, P("data"))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rebuilt = ShardedSupportBank.build(torch.from_numpy(f[live]), y[live], mesh, 7,
                                       use_prepared=False)
    torch.testing.assert_close(got, rebuilt.predict_fn()(torch.from_numpy(q)), **TOL)


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("ivf", [False, True])
def test_remove_rows_prepared_and_ivf_match_a_rebuilt_bank(ivf, precision):
    """Prepared shards (C = 200: class-sorted) and IVF shards (tiled, their
    rows class-sorted): the row map points each live row at its own
    prepared row; chained removals serve as a bank built over the rows
    left (full predict, and routed over every tile); the routing index
    and the bank removed from are left as they were."""
    f, y, q = _sharded_rows(S=900, C=200, seed=2)
    mesh = make_mesh(2, 4, devices=CPU8)
    bank = ShardedSupportBank.build(torch.from_numpy(f), y, mesh, 200, precision=precision,
                                    use_prepared=True, ivf=ivf)
    shards = [next(iter(c.values())) for c in bank.shards]
    labels = torch.cat([s.bank.labels for s in shards])
    assert torch.equal(labels[torch.from_numpy(bank.rowmap)], torch.from_numpy(y).int())
    drops, live = _chained_drops(900, seed=3)
    first = bank.remove_rows(drops[0])
    removed = first.remove_rows(drops[1])
    assert removed.dead == 120 and removed.capacity == bank.capacity
    assert torch.equal(torch.cat([next(iter(c.values())).bank.labels for c in bank.shards]),
                       labels)
    if ivf:
        for a, b in zip(bank.shards, removed.shards):
            assert next(iter(a.values())).ivf.cents is next(iter(b.values())).ivf.cents
    rebuilt = ShardedSupportBank.build(torch.from_numpy(f[live]), y[live], mesh, 200,
                                       precision=precision, use_prepared=True, ivf=ivf)
    got = removed.predict_fn()(torch.from_numpy(q))
    torch.testing.assert_close(got, rebuilt.predict_fn()(torch.from_numpy(q)), **TOL)
    if ivf:
        routed = removed.predict_fn(ivf_n_probe=64)(torch.from_numpy(q))
        torch.testing.assert_close(routed, got, rtol=0, atol=1e-6)


def test_remove_rows_bounds_and_empty():
    f, y, _ = _sharded_rows(S=256)
    bank = ShardedSupportBank.build(torch.from_numpy(f), y, make_mesh(1, 8, devices=CPU8), 7,
                                    use_prepared=True)
    assert bank.remove_rows(np.array([], np.int64)) is bank
    for rows in ([256], [-1]):
        with pytest.raises(IndexError):
            bank.remove_rows(np.array(rows))
    with pytest.raises(ValueError, match="row map"):
        ShardedSupportBank(mesh=bank.mesh, n_classes=7, shards=bank.shards).remove_rows([0])


@pytest.mark.parametrize("head_precision", ["f32", "int8"])
def test_nwnet_mesh_remove_support_tombstones(head_precision, monkeypatch):
    """``NWNet(mesh=(2, 4))``: a removal tombstones the sharded bank (raw
    f32 shards, or int8 IVF shards: their features the same tensors), the
    predicts close over the new bank, and full mode equals the meshless
    net after the same removal (and, at f32, JAX's mesh net); past the
    dead share it builds the bank again."""
    ds, _, x = _datasets(n=60)
    kw = dict(n_shot_full=5, fused_min_support=1, head_precision=head_precision)
    sharded = _port_net(ds, mesh=make_mesh(2, 4, devices=CPU8), **kw)
    alone = _port_net(ds, **kw)
    for net in (sharded, alone):
        net.precompute()
    bank = sharded.sharded_bank
    predict = sharded._sharded_predict
    drop = np.array([3, 9, 17])
    sharded.remove_support(drop)
    alone.remove_support(drop)
    new = sharded.sharded_bank
    assert new.dead == 3 and new.capacity == bank.capacity
    assert sharded._sharded_predict is not predict
    for a, b in zip(bank.shards, new.shards):
        sa, sb = next(iter(a.values())), next(iter(b.values()))
        assert (sa.bank.s is sb.bank.s) if new.prepared else (sa.feat is sb.feat)
    got = sharded.predict(x, "full")
    tol = dict(rtol=2e-3, atol=2e-3) if head_precision != "f32" else TOL
    torch.testing.assert_close(got, alone.predict(x, "full"), **tol)
    if head_precision == "f32":
        from nwhead_tpu.parallel import make_mesh as jmesh

        jnet, variables = _jax_net(ds, mesh=jmesh(2, 4), n_shot_full=5, fused_min_support=1)
        jnet.precompute(variables)
        jnet.remove_support(variables, drop)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnet.predict(variables, x, "full")),
                                   **TOL)
    monkeypatch.setattr(type(sharded), "_COMPACT_DEAD_FRAC", -1.0)
    sharded.remove_support([0, 1])
    assert sharded.sharded_bank.dead == 0 and len(sharded.sharded_bank.rowmap) == 15


def test_nwnet_mesh_add_support_rebuilds_the_sharded_bank():
    """``add_support`` under a mesh builds the sharded bank again over the
    grown rows (JAX's does too): full mode equals the meshless net after
    the same add, and the serving callable made before it serves it."""
    ds, pool, x = _datasets(n=60)
    kw = dict(n_shot_full=5, fused_min_support=1)
    sharded = _port_net(ds, mesh=make_mesh(2, 4, devices=CPU8), **kw)
    alone = _port_net(ds, **kw)
    for net in (sharded, alone):
        net.precompute()
    serve = sharded.make_serving_fn()
    bank = sharded.sharded_bank
    for net in (sharded, alone):
        net.add_support(pool.images[:6], pool.targets[:6])
    assert sharded.sharded_bank is not bank and len(sharded.sharded_bank.rowmap) == 26
    torch.testing.assert_close(serve(x), alone.predict(x, "full"), **TOL)


# ---------------------------------------------------------------------------
# On the card: K2/K4/K5/K6 and their partials over edited banks.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_edited_banks_match_plain(precision):
    """A concatenated bank (parts prepared apart, C = 200), the same bank
    tombstoned, and a tiled bank grown by ``prepare_for_concat``: K2, K4 or
    K5 (finalizing and ``partials``) and K6 over every tile against their
    plain versions on the same banks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    f, y, q = _rows(6_000, 512, 200, seed=7)
    ft, qt = torch.from_numpy(f).to(dev), torch.from_numpy(np.repeat(q, 11, 0)[:64]).to(dev)
    cat = tfused.concat_prepared([tfused.prepare_support(ft[a:b], y[a:b], 200,
                                                         precision=precision)
                                  for a, b in ((0, 5_800), (5_800, 6_000))])
    masked = tfused.mask_prepared_rows(cat, np.arange(0, 6_000, 7))
    like = tfused.prepare_support(ft[:5_800], y[:5_800], 200, precision=precision, block_s=1024)
    tiled = tfused.concat_prepared([like, tfused.prepare_for_concat(
        ft[5_800:], y[5_800:], 200, like, precision=precision)])
    # chip_smoke.py's tolerances: log-probs (bf16 atol 2e-3), partials rtol = atol.
    tol = dict(rtol=0, atol=2e-3) if precision == "bf16" else dict(rtol=2e-4, atol=2e-4)
    ptol = dict(rtol=2e-3, atol=2e-3) if precision == "bf16" else tol

    def plain(bank, partials=False):
        cpu = tfused.PreparedSupport(*(v.cpu() if isinstance(v, torch.Tensor) else v
                                       for v in bank))
        return tfused.nw_fused_from_prepared(qt.cpu(), cpu, 200, partials=partials)

    for bank in (cat, masked, tiled):
        got = tfused.nw_fused_from_prepared(qt, bank, 200)
        torch.testing.assert_close(got.cpu(), plain(bank), **tol)
        for g, w in zip(tfused.nw_fused_from_prepared(qt, bank, 200, partials=True),
                        plain(bank, partials=True)):
            torch.testing.assert_close(g.cpu(), w, **ptol)
    every = torch.arange(tiled.labels.shape[0] // 1024, dtype=torch.int32, device=dev)
    torch.testing.assert_close(tfused.nw_fused_from_prepared(qt, tiled, 200, tile_sel=every).cpu(),
                               plain(tiled), **tol)
