"""IVF-pruned serving of the port (``ops/ivf.py``, ``tile_sel`` in
``ops/fused_nw.py``, ``NWNet`` mode ``ivf``, ``serve --serve_mode ivf``)
against the JAX package, whose Pallas kernel runs here in interpret mode.

Tolerances: the tile-selected head against JAX's ``tile_sel`` within
rtol=atol=2e-4 (bf16 atol 2e-3) in log space where both stream the same
rows in the same order, and within 1e-5 in probability where the slot order
differs (a shuffled list sums in another order, as ``tests/test_ivf.py``
gates it). Routing (``select_tiles``, ``_dedup_rows``, tile lists) must be
equal. The k-means draws its randomness in two private functions; tests
substitute JAX's draws for them, and the built bank's permutation, labels,
``cvalid`` must then be equal and centroids and ``c2`` within rtol 1e-5.
The digits gate holds the port to the JAX package's own CPU numbers (jax
0.9.0): top-1 agreement with the exact head 0.8646 / 0.9896 / 1.0000 at
n_probe 1 / 2 / 4 over 288 queries in batches of 32, and
``ivf_auto_config(q[:32], target_agree=0.99)`` picking n_probe 3.

The CUDA kernel (K6) is tested on the card only (marker ``gpu``), with
``python -m pytest --noconftest -m gpu tests/test_torch_ivf.py``.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops import ivf as tivf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRECISIONS = ("f32", "bf16", "int8", "int4")
LOG_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-4, atol=2e-3),
           "int8": dict(rtol=2e-4, atol=2e-4), "int4": dict(rtol=2e-4, atol=2e-4)}


def _jax():
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.ops import ivf as jivf
    from nwhead_tpu.ops import pallas_nw

    return jax, jnp, jivf, pallas_nw


def _bank(S=3000, C=10, D=64, B=8, seed=0, clustered=False):
    """``tests/test_ivf.py``'s banks, as f32 numpy."""
    rng = np.random.default_rng(seed)
    if clustered:
        cents = rng.standard_normal((C, D)) * 4.0
        sy = rng.integers(0, C, S)
        sf = cents[sy] + 0.3 * rng.standard_normal((S, D))
        q = cents[rng.integers(0, C, B)] + 0.3 * rng.standard_normal((B, D))
    else:
        sf = rng.standard_normal((S, D))
        sy = rng.integers(0, C, S)
        q = rng.standard_normal((B, D))
    return sf.astype(np.float32), sy.astype(np.int32), q.astype(np.float32)


def _jax_labels(jprep):
    return np.asarray(jprep.lane).reshape(-1).astype(np.int64)


def _prob_diff(a, b) -> float:
    return float(np.abs(np.exp(np.asarray(a)) - np.exp(np.asarray(b))).max())


def _use_jax_draws(monkeypatch, seed=0):
    """Replace the port's two k-means draws by the JAX package's: its
    subsample pick and its k-means++ seeding, from ``PRNGKey(seed)`` split
    as ``prepare_support_ivf`` splits it."""
    jax, jnp, jivf, _ = _jax()
    ksamp, kfit = jax.random.split(jax.random.PRNGKey(seed))

    def fit_sample(n_valid, n_fit, generator):
        return np.asarray(jax.random.choice(ksamp, n_valid, (n_fit,), replace=False))

    def kmeans_pp_init(x, k, generator):
        return torch.from_numpy(np.array(jivf._kmeans_pp_init(kfit, jnp.asarray(x.numpy()), k)))

    monkeypatch.setattr(tivf, "_fit_sample", fit_sample)
    monkeypatch.setattr(tivf, "_kmeans_pp_init", kmeans_pp_init)


# ---------------------------------------------------------------------------
# The tiled prepared bank and the tile-selected head.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["c10_b512", "c150_b128"])
def test_prepare_support_tiles_match_jax(case, precision):
    """``block_s`` resolves, pads and orders the bank as JAX's does: the same
    tile size and count, labels (``-1`` on masked and padding rows), codes
    or features, self-norms and scales, row for row."""
    _, jnp, _, jfused = _jax()
    S, C, block_s = {"c10_b512": (3000, 10, 512), "c150_b128": (1000, 150, 100)}[case]
    sf, sy, _ = _bank(S=S, C=C, seed=1)
    mask = (np.random.default_rng(2).random(S) > 0.1).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jfused.prepare_support(jnp.asarray(sf), jnp.asarray(sy), C, precision=precision,
                                    block_s=block_s, support_mask=jnp.asarray(mask))
        tp = tfused.prepare_support(torch.from_numpy(sf), sy, C, precision=precision,
                                    block_s=block_s, support_mask=torch.from_numpy(mask))
    n_tiles, nchunk, _ = jp.lane.shape
    assert tp.block_s == nchunk * 128 and tp.labels.shape[0] == n_tiles * tp.block_s
    np.testing.assert_array_equal(tp.labels.numpy(), _jax_labels(jp))
    np.testing.assert_allclose(tp.s2.numpy(), np.asarray(jp.s2c).reshape(-1), rtol=1e-6)
    if precision in ("f32", "bf16"):
        np.testing.assert_array_equal(tp.s.float().numpy(),
                                      np.asarray(jp.s.astype(jnp.float32))[:, :64])
    else:
        np.testing.assert_allclose(tp.sscale.numpy(), np.asarray(jp.sscale).reshape(-1),
                                   rtol=1e-6)
        codes = tfused.bank_codes(tp).numpy().astype(np.int32)
        b = np.asarray(jp.s)
        if precision == "int4":
            b = b.view(np.int8).astype(np.int32)
            b = np.concatenate([(b & 15) - 8, b >> 4], axis=1)
        np.testing.assert_array_equal(codes[:, :64], b.astype(np.int32)[:, :64])


@pytest.fixture(scope="module")
def tile_banks():
    """One JAX and one port bank per precision, ``block_s=512`` (6 tiles)."""
    _, jnp, _, jfused = _jax()
    sf, sy, q = _bank(seed=1)
    banks = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for prec in PRECISIONS:
            banks[prec] = (
                jfused.prepare_support(jnp.asarray(sf), jnp.asarray(sy), 10, precision=prec,
                                       block_s=512),
                tfused.prepare_support(torch.from_numpy(sf), sy, 10, precision=prec,
                                       block_s=512))
    return sf, sy, q, banks


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tile_sel_matches_jax(tile_banks, precision):
    """The plain tile-selected head against JAX's ``tile_sel`` kernel: the
    identity list (log space), a shuffled list with empty slots everywhere
    (probability space) and per-group 2-D lists (one row per 4 queries)."""
    _, jnp, _, jfused = _jax()
    _, _, q, banks = tile_banks
    jp, tp = banks[precision]
    n_tiles = jp.lane.shape[0]
    qt = torch.from_numpy(q)

    ident = np.arange(n_tiles, dtype=np.int32)
    want = jfused.nw_fused_from_prepared(jnp.asarray(q), jp, 10, tile_sel=jnp.asarray(ident))
    got = tfused.nw_fused_from_prepared(qt, tp, 10, tile_sel=torch.from_numpy(ident))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOG_TOL[precision])

    sel = np.full(2 * n_tiles + 1, -1, np.int32)
    sel[1::2] = np.random.default_rng(2).permutation(n_tiles)
    want = jfused.nw_fused_from_prepared(jnp.asarray(q), jp, 10, tile_sel=jnp.asarray(sel))
    got = tfused.nw_fused_from_prepared(qt, tp, 10, tile_sel=torch.from_numpy(sel))
    assert _prob_diff(got, want) < 1e-5

    sel2 = np.array([[0, 3, -1], [5, -1, 1]], np.int32)
    want = jfused.nw_fused_from_prepared(jnp.asarray(q), jp, 10, tile_sel=jnp.asarray(sel2),
                                         block_b=4)
    got = tfused.nw_fused_from_prepared(qt, tp, 10, tile_sel=torch.from_numpy(sel2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOG_TOL[precision])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tile_subset_equals_masked_bank(tile_banks, precision):
    """Streaming tiles {0, 2, 3} equals the full head over a bank whose other
    rows are masked; an all-empty list (and a list of tiles holding masked
    rows only) gives the log floor, never NaN, as JAX's kernel does."""
    _, jnp, _, jfused = _jax()
    sf, sy, q, banks = tile_banks
    jp, tp = banks[precision]
    qt = torch.from_numpy(q)
    keep = [0, 2, 3]
    mask = np.zeros(len(sy), np.float32)
    for t in keep:
        mask[t * 512:(t + 1) * 512] = 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = tfused.prepare_support(torch.from_numpy(sf), sy, 10, precision=precision,
                                    block_s=512, support_mask=torch.from_numpy(mask))
    got = tfused.nw_fused_from_prepared(qt, tp, 10, tile_sel=torch.tensor(keep))
    assert _prob_diff(got, tfused.nw_fused_from_prepared(qt, tm, 10)) < 1e-5

    empty = np.full(3, -1, np.int32)
    floor = tfused.nw_fused_from_prepared(qt, tp, 10, tile_sel=torch.from_numpy(empty))
    want = jfused.nw_fused_from_prepared(jnp.asarray(q), jp, 10, tile_sel=jnp.asarray(empty))
    np.testing.assert_array_equal(floor.numpy(), np.asarray(want))
    dead = tfused.nw_fused_from_prepared(qt, tm, 10, tile_sel=torch.tensor([1, 4, -1]))
    np.testing.assert_array_equal(dead.numpy(), floor.numpy())
    assert torch.isfinite(floor).all()


def test_tile_sel_refuses_untiled_bank_and_uneven_groups():
    prep = tfused.prepare_support(torch.randn(300, 8), np.arange(300) % 3, 3)
    with pytest.raises(ValueError, match="block_s"):
        tfused.nw_fused_from_prepared(torch.randn(4, 8), prep, 3, tile_sel=torch.tensor([0]))
    prep = tfused.prepare_support(torch.randn(300, 8), np.arange(300) % 3, 3, block_s=128)
    with pytest.raises(ValueError, match="equal groups"):
        tfused.nw_fused_from_prepared(torch.randn(4, 8), prep, 3,
                                      tile_sel=torch.zeros((3, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------

def test_select_tiles_and_dedup_match_jax():
    """Union, order, ``-1`` padding and the cap ``min(B * n_probe, n_tiles)``
    equal JAX's, ties included (``-inf`` tiles that cannot be routed to)."""
    jax, jnp, jivf, _ = _jax()
    aff = np.asarray([[0.0, 5.0, 1.0, 3.0], [0.0, 5.0, 1.0, 3.0], [9.0, 0.1, 0.2, 0.0]],
                     np.float32)
    assert tivf.select_tiles(torch.from_numpy(aff), 2).tolist() == [0, 1, 2, 3]
    rng = np.random.default_rng(0)
    for _ in range(5):
        B, n_tiles = int(rng.integers(1, 9)), int(rng.integers(2, 33))
        p = int(rng.integers(1, n_tiles + 3))
        aff = rng.standard_normal((B, n_tiles)).astype(np.float32)
        aff[:, rng.random(n_tiles) < 0.3] = -np.inf
        got = tivf.select_tiles(torch.from_numpy(aff), p).numpy()
        np.testing.assert_array_equal(got, np.asarray(jivf.select_tiles(jnp.asarray(aff), p)))
        assert len(got) == min(B * min(p, n_tiles), n_tiles)
        ids = rng.integers(0, n_tiles, (3, 7)).astype(np.int32)
        np.testing.assert_array_equal(
            tivf._dedup_rows(torch.from_numpy(ids), n_tiles, 5).numpy(),
            np.asarray(jivf._dedup_rows(jnp.asarray(ids), n_tiles, 5)))


@pytest.fixture(scope="module")
def clustered_ivf():
    """A clustered bank (4,096 rows, 20 classes, 256-row tiles) built by both
    packages in cluster order, the port with JAX's draws."""
    _, jnp, jivf, _ = _jax()
    sf, sy, q = _bank(S=4096, C=20, B=44, seed=17, clustered=True)
    with pytest.MonkeyPatch.context() as mp:
        _use_jax_draws(mp)
        t = tivf.prepare_support_ivf(torch.from_numpy(sf), sy, 20, block_s=256, sample=2048)
    j = jivf.prepare_support_ivf(jnp.asarray(sf), jnp.asarray(sy), 20, block_s=256, sample=2048)
    return sf, sy, q, j, t


@pytest.mark.parametrize("group_b", [None, 8, 24])
def test_ivf_log_probs_match_jax(clustered_ivf, group_b):
    """Single-union and grouped routing (B=44, not a multiple of 8 or 24)
    against JAX, and the same tile lists; at ``n_probe = n_tiles`` equal to
    the full head."""
    _, jnp, jivf, _ = _jax()
    _, _, q, j, t = clustered_ivf
    qt = torch.from_numpy(q)
    want = jivf.nw_fused_ivf_log_probs(jnp.asarray(q), j, 20, n_probe=2, group_b=group_b)
    got = tivf.nw_fused_ivf_log_probs(qt, t, 20, n_probe=2, group_b=group_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    n_tiles = t.cents.shape[0]
    full = tfused.nw_fused_from_prepared(qt, t.prep, 20)
    pruned = tivf.nw_fused_ivf_log_probs(qt, t, 20, n_probe=n_tiles, group_b=group_b)
    assert _prob_diff(pruned, full) < 1e-6
    assert (got.argmax(1) == full.argmax(1)).all()


@pytest.mark.parametrize("order", ["class", "cluster"])
def test_prepare_support_ivf_matches_jax(clustered_ivf, order):
    """Both row orders: the permutation (as labels and features), the tile
    centroids (rtol 1e-5), ``c2`` and ``cvalid`` equal JAX's, masked rows
    last and never routed to."""
    _, jnp, jivf, _ = _jax()
    sf, sy, _, j, t = clustered_ivf
    if order == "class":
        mask = np.ones(len(sy), np.float32)
        mask[1000:1400] = 0.0
        j = jivf.prepare_support_ivf(jnp.asarray(sf), jnp.asarray(sy), 20, block_s=256,
                                     order="class", support_mask=jnp.asarray(mask))
        t = tivf.prepare_support_ivf(torch.from_numpy(sf), sy, 20, block_s=256, order="class",
                                     support_mask=torch.from_numpy(mask))
        assert float(t.cvalid.sum()) < t.cents.shape[0]
    np.testing.assert_array_equal(t.prep.labels.numpy(), _jax_labels(j.prep))
    np.testing.assert_array_equal(t.prep.s.numpy(), np.asarray(j.prep.s)[:, :64])
    np.testing.assert_allclose(t.cents.numpy(), np.asarray(j.cents)[:, :64], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.c2.numpy(), np.asarray(j.c2), rtol=1e-5)
    np.testing.assert_array_equal(t.cvalid.numpy(), np.asarray(j.cvalid))


def test_digits_gate(monkeypatch):
    """The JAX package's digits recipe (``scripts/ivf_lab.py --real
    digits``): 1,500 raw-pixel rows, 128-row tiles (12, cluster order), 288
    queries in batches of 32. With JAX's draws the port's bank and every
    batch's tile list equal JAX's routing, and the plain curve and auto
    config read the JAX package's CPU numbers."""
    from sklearn.datasets import load_digits

    jax, jnp, jivf, _ = _jax()
    X, y = load_digits(return_X_y=True)
    X = (X / 16.0).astype(np.float32)
    sf, sy, q = X[:1500], y[:1500].astype(np.int32), torch.from_numpy(X[1500:])
    _use_jax_draws(monkeypatch)
    t = tivf.prepare_support_ivf(torch.from_numpy(sf), sy, 10, block_s=128)
    j = jivf.prepare_support_ivf(jnp.asarray(sf), jnp.asarray(sy), 10, block_s=128)
    assert t.cents.shape[0] == 12
    np.testing.assert_array_equal(t.prep.labels.numpy(), _jax_labels(j.prep))
    exact = tfused.nw_fused_from_prepared(q, t.prep, 10).argmax(1)
    jaff = jivf._route_affinity(jnp.asarray(q.numpy()), j, "l2")
    curve = {}
    for p in (1, 2, 4):
        jids = np.asarray(jax.lax.top_k(jaff, p)[1])
        agree = []
        for i in range(0, 288, 32):
            qb = q[i:i + 32]
            union = np.unique(jids[i:i + 32])  # JAX's routing of the batch
            jsel = np.concatenate([union, np.full(min(32 * p, 12) - len(union), -1)])
            np.testing.assert_array_equal(tivf.route_tiles(qb, t, p, mode="l2").numpy(), jsel)
            out = tivf.nw_fused_ivf_log_probs(qb, t, 10, n_probe=p)
            agree.append(float((out.argmax(1) == exact[i:i + 32]).float().mean()))
        curve[p] = round(float(np.mean(agree)), 4)
    assert curve == {1: 0.8646, 2: 0.9896, 4: 1.0}
    cfg = tivf.ivf_auto_config(q[:32], t, 10, target_agree=0.99)
    assert (cfg.n_probe, cfg.group_b, cfg.agreement, cfg.route_diversity) == (3, None, 1.0, 9)


# ---------------------------------------------------------------------------
# NWNet mode "ivf" and the serve CLI.
# ---------------------------------------------------------------------------

def _net(**kw):
    """A net over a 1,100-item bank (two 1,024-row tiles) with a small
    linear featurizer."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=1100, n_classes=4, size=8, seed=0)
    torch.manual_seed(0)
    feat = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(8 * 8 * 3, 16))
    net = NWNet(feat, 4, support_dataset=ds, device="cpu", n_shot_full=400, **kw)
    q = make_synthetic_dataset(n=40, n_classes=4, size=8, seed=3).gather(np.arange(40))
    return net, q


def test_nwnet_ivf_mode():
    """Full probe equals full mode; the IVF bank is cached and rebuilt after
    precompute; mode ivf needs precompute; the serving fn serves it."""
    net, q = _net(ivf_n_probe=10_000)
    with pytest.raises(ValueError, match="precompute"):
        net.predict(q, mode="ivf")
    net.precompute()
    ivf = net._ivf_bank()
    assert ivf.cents.shape[0] == 2
    full = net.predict(q, mode="full")
    assert _prob_diff(net.predict(q, mode="ivf"), full) < 1e-5
    assert net._ivf_bank() is ivf
    net.precompute()
    assert net._ivf_cache is None
    assert _prob_diff(net.make_serving_fn(mode="ivf")(q), full) < 1e-5
    assert net._ivf_bank() is not ivf


def test_nwnet_ivf_auto():
    """``"auto"`` raises in make_serving_fn until calibrated, and the first
    predict calibrates on its batch."""
    net, q = _net(ivf_n_probe="auto", ivf_group_b=8)
    net.precompute()
    with pytest.raises(ValueError, match="unresolved"):
        net.make_serving_fn(mode="ivf")
    out = net.predict(q, mode="ivf")
    assert isinstance(net.ivf_n_probe, int) and net.ivf_group_b in (8, None)
    serve = net.make_serving_fn(mode="ivf")
    torch.testing.assert_close(serve(q), out)
    with pytest.warns(UserWarning, match="only 8 queries"):
        net.calibrate_ivf(x=q[:8])


def test_serve_cli_ivf_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.serve", "--device", "cpu", "--dataset",
         "synthetic", "--arch", "resnet10", "--latency_bench", "--bench_batches", "2",
         "--batch_size", "8", "--serve_mode", "ivf", "--ivf_probe", "auto"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IVF auto-calibrated on 32 val queries" in out.stdout
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["serve_mode"] == "ivf" and isinstance(report["ivf_probe"], int)


# ---------------------------------------------------------------------------
# On the card: K6 against its plain version.
# ---------------------------------------------------------------------------

GPU_SHAPES = [(64, 40_000, 512, 200, 1024), (37, 5_000, 509, 150, 128), (24, 3_000, 64, 10, 512),
              (64, 30_000, 512, 1000, 1024), (37, 6_000, 509, 1000, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_cuda_tile_sel_matches_plain(precision, shape):
    """K6 against ``_nw_prepared_sel_plain`` on the card: one shuffled list
    with empty slots and ids past the bank, grouped lists at group_b 8, 16
    and 24 (B not a multiple), an all-empty list; all five kernels, masked
    rows holding NaN; rtol=atol=2e-4 (bf16 atol 2e-3). The identity list
    equals K2 within 2e-4. At C > 128 also a ``keep_order=True`` bank and
    the ``partials=True`` route; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    B, S, D, C, block_s = shape
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    sy = rng.integers(0, C, size=S)
    valid = rng.random(S) > 0.03
    valid[0] = True
    s[torch.from_numpy(~valid).to(dev)] = float("nan")
    mask = torch.from_numpy(valid.astype(np.float32))
    floating = precision in ("f32", "bf16")
    wrapper = tfused.nw_prepared_sel_cuda if floating else tfused.nw_prepared_sel_quant_cuda
    partials = (tfused.nw_prepared_sel_partials_cuda if floating
                else tfused.nw_prepared_sel_partials_quant_cuda)
    for kernel, keep_order in [(k, False) for k in KERNEL_NAMES] + (
            [("euclidean", True), ("cosine", True)] if C > 128 else []):
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prep = tfused.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                          precision=precision, block_s=block_s,
                                          keep_order=keep_order)
        n_tiles = prep.labels.shape[0] // prep.block_s
        qk, scale, mode, qscale = tfused._prepared_query(q, prep, kernel, params)
        shuffled = np.full(2 * n_tiles + 2, -1, np.int32)
        shuffled[1:2 * n_tiles:2] = rng.permutation(n_tiles)
        shuffled[-1] = n_tiles + 3
        lists = [(shuffled, B), (np.full(4, -1, np.int32), B)]
        for g in (8, 16, 24):
            lists.append((rng.integers(-1, n_tiles, (-(-B // g), 3)).astype(np.int32), g))
        for sel, group in lists:
            pad = (sel.shape[0] if sel.ndim == 2 else 1) * group - B
            qg = torch.cat([qk, qk[-1:].expand(pad, -1)]) if pad else qk
            qs = None if qscale is None else torch.cat([qscale, qscale[-1:].expand(pad)])
            tsel = torch.from_numpy(sel).to(dev)
            before = wrapper.launches
            got = wrapper(qg, prep, scale, mode, C, qs, tsel)
            want = tfused._nw_prepared_sel_plain(qg, prep, scale, mode, C, qs, tsel)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, **LOG_TOL[precision])
            if C > 128:
                assert torch.equal(got, wrapper(qg, prep, scale, mode, C, qs, tsel))
                tol = LOG_TOL[precision]["atol"]
                for g, w in zip(partials(qg, prep, scale, mode, C, qs, tsel),
                                tfused._nw_prepared_sel_plain(qg, prep, scale, mode, C, qs,
                                                              tsel, partials=True)):
                    torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        ident = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        dense = tfused.nw_fused_from_prepared(q, prep, C, kernel=kernel, kernel_params=params)
        torch.testing.assert_close(
            tfused.nw_fused_from_prepared(q, prep, C, kernel=kernel, kernel_params=params,
                                          tile_sel=ident), dense, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_tile_sel_refuses_what_it_does_not_take():
    """A list on the host, an untiled bank or a float query for an int8
    bank raises; nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    dev = torch.device("cuda")
    s = torch.randn(300, 8, device=dev)
    prep = tfused.prepare_support(s, np.arange(300) % 3, 3, block_s=128)
    q, scale, mode, _ = tfused._prepared_query(torch.randn(4, 8, device=dev), prep)
    with pytest.raises(ValueError, match="tile_sel on"):
        tfused.nw_prepared_sel_cuda(q, prep, scale, mode, 3, None, torch.tensor([0]))
    flat = tfused.prepare_support(s, np.arange(300) % 3, 3)
    with pytest.raises(ValueError, match="block_s"):
        tfused.nw_prepared_sel_cuda(q, flat, scale, mode, 3, None,
                                    torch.tensor([0], device=dev))
    p8 = tfused.prepare_support(s, np.arange(300) % 3, 3, block_s=128, precision="int8")
    q8, _, _, qscale = tfused._prepared_query(torch.randn(4, 8, device=dev), p8)
    with pytest.raises(ValueError, match="query"):
        tfused.nw_prepared_sel_quant_cuda(q8.float(), p8, scale, mode, 3, qscale,
                                          torch.tensor([0], device=dev))
