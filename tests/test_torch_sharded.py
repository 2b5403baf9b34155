"""Support-sharded serving of the port (``parallel/``, ``nw/streaming.py``,
``nw_fused_partials`` and ``nw_fused_from_prepared(partials=True)`` in
``ops/fused_nw.py``, ``NWNet(mesh=...)``, ``serve --mesh``) against the JAX
package, whose Pallas kernels run here in interpret mode on the eight
virtual CPU devices of ``tests/conftest.py``; the port's meshes are eight
copies of the CPU device.

Tolerances: partials ``m`` within rtol 1e-5, ``l`` and ``acc`` within
rtol=atol=2e-4 (bf16 2e-3): the same sums in another order. Sharded
log-probs within 2e-4 (bf16 2e-3) of JAX's sharded bank and of the port's
own unsharded head at the same precision; routed (IVF) sharded log-probs
the same, with the per-shard tile size and count equal to JAX's. The
host-path eval batches of the trainer equal JAX's exactly.

The CUDA routes (K1 and K2/K4/K5/K6 ``partials=True``, the sharded bank
on four shards of one card, streaming) are tested on the card only
(marker ``gpu``): ``python -m pytest --noconftest -m gpu
tests/test_torch_sharded.py``. That machine has no jax, so this module
imports the JAX package inside the tests that compare with it.
"""

import copy
import warnings

import numpy as np
import pytest
import torch
from torch import nn

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.parallel import ShardedSupportBank, make_mesh, merge_partials, nw_partials
from nwhead_tpu_torch.parallel import sharded_bank as tsharded

torch.set_num_threads(1)

KERNELS = ("euclidean", "hypersphere_euclidean", "cosine", "dotproduct", "clip")
PRECISIONS = ("f32", "bf16", "int8", "int4")
MESHES = ((1, 8), (2, 4), (4, 2))
CPU8 = [torch.device("cpu")] * 8
LOGIT_SCALE = 1.3


def _tol(precision):
    return 2e-3 if precision == "bf16" else 2e-4


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _params(kernel, framework):
    """clip's logit_scale as each package takes it; nothing for the others."""
    if kernel != "clip":
        return None
    if framework == "jax":
        return {"logit_scale": _jax()[1].float32(LOGIT_SCALE)}
    return {"logit_scale": torch.tensor(LOGIT_SCALE)}


def _bank(S, C, D, B, seed=0, clustered=False):
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


def _assert_partials(got, want, precision):
    """``(m, l, acc)`` of the port against JAX's (numpy)."""
    tol = _tol(precision)
    m, l, acc = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(got[0].float().numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].float().numpy(), l, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[2].float().numpy(), acc, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K1 partials=True and the per-shard partials.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_fused_partials_match_jax(kernel, precision):
    """``nw_fused_partials`` (K1 ``partials=True``'s plain version here) and
    ``nw_partials`` against JAX's ``nw_fused_partials`` and ``nw_partials(
    use_fused=False)``: masked rows, then an all-masked shard (``m`` the
    finite -inf, ``l = acc = 0``), which the merge ignores."""
    jax, jnp = _jax()
    from nwhead_tpu.ops.pallas_nw import nw_fused_partials as j_partials
    from nwhead_tpu.parallel import nw_partials as j_nw_partials

    sf, sy, q = _bank(S=300, C=5, D=32, B=6, seed=1)
    mask = (np.random.default_rng(2).random(300) > 0.1).astype(np.float32)
    jp, tp = _params(kernel, "jax"), _params(kernel, "torch")
    for m_np in (mask, np.zeros_like(mask)):
        want = j_partials(jnp.asarray(q), jnp.asarray(sf), jnp.asarray(sy), 5, kernel=kernel,
                          kernel_params=jp, support_mask=jnp.asarray(m_np),
                          precision=precision)
        got = tfused.nw_fused_partials(torch.from_numpy(q), torch.from_numpy(sf),
                                       torch.from_numpy(sy), 5, kernel=kernel,
                                       kernel_params=tp, support_mask=torch.from_numpy(m_np),
                                       precision=precision)
        _assert_partials(got, want, precision)
        if precision == "f32":
            want = j_nw_partials(jnp.asarray(q), jnp.asarray(sf), jnp.asarray(sy),
                                 jnp.asarray(m_np), 5, kernel=kernel, kernel_params=jp,
                                 use_fused=False)
            got = nw_partials(torch.from_numpy(q), torch.from_numpy(sf), torch.from_numpy(sy),
                              torch.from_numpy(m_np), 5, kernel=kernel, kernel_params=tp)
            _assert_partials(got, want, precision)
    assert float(got[0].min()) == tfused._NEG_INF and float(got[1].abs().max()) == 0.0
    # Merged with a live shard, the empty one changes nothing.
    live = nw_partials(torch.from_numpy(q), torch.from_numpy(sf), torch.from_numpy(sy),
                       torch.from_numpy(mask), 5, kernel=kernel, kernel_params=tp)
    torch.testing.assert_close(merge_partials([got, live, got]), merge_partials([live]),
                               rtol=0, atol=0)


def test_fused_partials_ignore_nan_in_masked_rows():
    """Masked rows may hold NaN: the partials equal those of zeroed rows."""
    sf, sy, q = _bank(S=200, C=4, D=16, B=5, seed=3)
    mask = np.ones(200, np.float32)
    mask[::7] = 0
    nan = sf.copy()
    nan[mask == 0] = np.nan
    for kernel in KERNELS:
        args = dict(kernel=kernel, kernel_params=_params(kernel, "torch"),
                    support_mask=torch.from_numpy(mask))
        a = tfused.nw_fused_partials(torch.from_numpy(q), torch.from_numpy(nan), sy, 4, **args)
        b = tfused.nw_fused_partials(torch.from_numpy(q), torch.from_numpy(sf), sy, 4, **args)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2/K4/K5/K6 partials=True.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["euclidean", "clip"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_prepared_partials_match_jax(precision, kernel):
    """``nw_fused_from_prepared(partials=True)`` against JAX's at every bank
    precision, over the whole bank and with a ``tile_sel`` that has empty
    slots, one that names only a tile of masked rows and one with no tile
    at all. Where a query meets no valid row the port's partials are ``m``
    the finite -inf, ``l = acc = 0``; JAX's l2 prepared kernel scores its
    masked rows -1e15 (their self-norm 1e30) and reads ``(-1e15, rows, 0)``
    there. Both merge to the log floor, so those are held after the
    merge."""
    jax, jnp = _jax()
    from nwhead_tpu.ops import pallas_nw as jfused

    S, C, block_s = 700, 5, 128
    sf, sy, q = _bank(S=S, C=C, D=32, B=6, seed=4)
    mask = (np.random.default_rng(5).random(S) > 0.1).astype(np.float32)
    mask[256:384] = 0.0  # tile 2: masked rows only
    jp, tp = _params(kernel, "jax"), _params(kernel, "torch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbank = jfused.prepare_support(jnp.asarray(sf), jnp.asarray(sy), C, kernel=kernel,
                                       precision=precision, block_s=block_s,
                                       support_mask=jnp.asarray(mask))
        tbank = tfused.prepare_support(torch.from_numpy(sf), sy, C, kernel=kernel,
                                       precision=precision, block_s=block_s,
                                       support_mask=torch.from_numpy(mask))
    for sel, empty in ((None, False), ([4, -1, 0, -1, 5], False), ([2, -1], True),
                       ([-1, -1, -1], True)):
        want = jfused.nw_fused_from_prepared(
            jnp.asarray(q), jbank, C, kernel=kernel, kernel_params=jp, partials=True,
            tile_sel=None if sel is None else jnp.asarray(sel, jnp.int32))
        got = tfused.nw_fused_from_prepared(
            torch.from_numpy(q), tbank, C, kernel=kernel, kernel_params=tp, partials=True,
            tile_sel=None if sel is None else torch.tensor(sel, dtype=torch.int32))
        if empty:
            assert (got[0] == tfused._NEG_INF).all() and not got[1].any() and not got[2].any()
            want = [torch.from_numpy(np.array(x)) for x in want]
            torch.testing.assert_close(merge_partials([got]), merge_partials([want]),
                                       rtol=0, atol=0)
        else:
            _assert_partials(got, want, precision)


def test_grouped_partials_are_refused():
    """The sharded path routes a batch to one union; the port adds no
    grouped partials the JAX package lacks."""
    from nwhead_tpu_torch.ops import ivf as tivf

    sf, sy, q = _bank(S=300, C=4, D=8, B=8, seed=6)
    ivf = tivf.prepare_support_ivf(torch.from_numpy(sf), sy, 4, block_s=128, order="class")
    with pytest.raises(ValueError, match="group_b"):
        tivf.nw_fused_ivf_log_probs(torch.from_numpy(q), ivf, 4, n_probe=1, group_b=4,
                                    partials=True)


# ---------------------------------------------------------------------------
# The mesh and the sharded bank.
# ---------------------------------------------------------------------------

def test_make_mesh_resolves_axes_as_jax():
    from nwhead_tpu.parallel import make_mesh as j_make_mesh

    for axes in ((None, None), (2, None), (None, 4), (4, 2), (1, 8)):
        want = j_make_mesh(*axes)
        got = make_mesh(*axes, devices=CPU8)
        assert got.shape == dict(want.shape) and got.size == 8
        assert got.devices.shape == (got.shape["data"], got.shape["support"], 1)
    # The model axis, as JAX resolves it (ported with data-parallel training).
    got, want = make_mesh(2, 2, n_model=2, devices=CPU8), j_make_mesh(2, 2, n_model=2)
    assert got.shape == dict(want.shape) == {"data": 2, "support": 2, "model": 2}
    with pytest.raises(ValueError):
        make_mesh(3, 2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("mode", ["raw", *PRECISIONS])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_bank_matches_jax(mesh_shape, mode):
    """``ShardedSupportBank`` against JAX's: 203 rows over the support axis
    (unequal shards, the padding masked), raw or prepared at each
    precision, and against the port's own unsharded head."""
    jax, jnp = _jax()
    from nwhead_tpu.parallel import ShardedSupportBank as JBank
    from nwhead_tpu.parallel import make_mesh as j_make_mesh

    sf, sy, q = _bank(S=203, C=5, D=16, B=8, seed=7)
    prepared = mode != "raw"
    precision = mode if prepared else "f32"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbank = JBank.build(sf, sy, j_make_mesh(*mesh_shape), 5, precision=precision,
                            use_prepared=prepared)
        want = np.asarray(jbank.predict_fn()(jnp.asarray(q)))
        bank = ShardedSupportBank.build(sf, sy, make_mesh(*mesh_shape, devices=CPU8), 5,
                                        precision=precision, use_prepared=prepared)
        got = bank.predict_fn()(torch.from_numpy(q))
        tbank = tfused.prepare_support(torch.from_numpy(sf), sy, 5, precision=precision)
    assert bank.prepared == prepared and bank.local == 203 // mesh_shape[1] + 1
    assert bank.capacity == bank.local * mesh_shape[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=_tol(precision), atol=_tol(precision))
    alone = tfused.nw_fused_from_prepared(torch.from_numpy(q), tbank, 5)
    torch.testing.assert_close(got, alone, rtol=_tol(precision), atol=_tol(precision))


@pytest.mark.parametrize("n_probe", [1, 2])
@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_sharded_ivf_matches_jax(mesh_shape, precision, n_probe):
    """``build(ivf=True)``: each shard class-sorted and tiled at JAX's tile
    size (1,024 rows: two tiles a shard here), routed against its own tiles
    with ``ivf_n_probe`` 1 and 2, against JAX's routed sharded bank; at full
    probe, the unrouted sharded bank."""
    jax, jnp = _jax()
    from nwhead_tpu.parallel import ShardedSupportBank as JBank
    from nwhead_tpu.parallel import make_mesh as j_make_mesh

    S = {(4, 2): 2500, (1, 8): 8500}[mesh_shape]
    sf, sy, q = _bank(S=S, C=5, D=16, B=8, seed=8, clustered=True)
    n_shards = mesh_shape[1]
    jbank = JBank.build(sf, sy, j_make_mesh(*mesh_shape), 5, precision=precision,
                        use_prepared=True, ivf=True)
    bank = ShardedSupportBank.build(sf, sy, make_mesh(*mesh_shape, devices=CPU8), 5,
                                    precision=precision, use_prepared=True, ivf=True)
    n_tiles, nchunk, _ = jbank.prepared.lane.shape
    for copies in bank.shards:
        (shard,) = copies.values()
        assert shard.ivf.prep.block_s == nchunk * 128 == 1024
        assert shard.ivf.cents.shape[0] == n_tiles // n_shards == 2
    want = np.asarray(jbank.predict_fn(ivf_n_probe=n_probe)(jnp.asarray(q)))
    got = bank.predict_fn(ivf_n_probe=n_probe)(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    full = bank.predict_fn(ivf_n_probe=2)(torch.from_numpy(q))
    torch.testing.assert_close(full, bank.predict_fn()(torch.from_numpy(q)), rtol=2e-4,
                               atol=2e-4)


def test_sharded_bank_refusals():
    sf, sy, q = _bank(S=64, C=4, D=8, B=6, seed=9)
    mesh = make_mesh(2, 4, devices=CPU8)
    with pytest.raises(ValueError, match="prepared"):
        ShardedSupportBank.build(sf, sy, mesh, 4, precision="bf16", use_prepared=False)
    raw = ShardedSupportBank.build(sf, sy, mesh, 4, ivf=True)
    assert not raw.prepared and not raw.ivf  # CPU default: raw; ivf needs prepared
    with pytest.raises(ValueError, match="raw-mode"):
        raw.predict_fn(ivf_n_probe=2)
    with pytest.raises(ValueError, match="ivf=True"):
        ShardedSupportBank.build(sf, sy, mesh, 4, use_prepared=True).predict_fn(ivf_n_probe=2)
    with pytest.raises(ValueError, match="data rows"):
        raw.predict_fn()(torch.from_numpy(q[:5]))


def test_serving_block_s_is_jax():
    from nwhead_tpu.ops.pallas_nw import _serving_block_s

    for S in (1, 1000, 262_143, 262_144, 4_194_303, 4_194_304, 10_000_000):
        assert tsharded._serving_block_s(S) == _serving_block_s(S)


# ---------------------------------------------------------------------------
# Streaming over a host bank.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [None, 64])
@pytest.mark.parametrize("kernel", ["euclidean", "cosine"])
def test_streaming_matches_jax(kernel, chunk_size):
    """Ragged host chunks (50, 50, 37 rows) padded with masked rows to one
    shape, against JAX's ``nw_streaming_log_probs`` and the one-pass head."""
    jax, jnp = _jax()
    from nwhead_tpu.nw.streaming import nw_streaming_log_probs as j_stream

    from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    sf, sy, q = _bank(S=137, C=6, D=16, B=5, seed=10)
    chunks = [(sf[i:i + 50], sy[i:i + 50]) for i in range(0, 137, 50)]
    want = np.asarray(j_stream(jnp.asarray(q), chunks, 6, kernel=kernel,
                               chunk_size=chunk_size))
    got = nw_streaming_log_probs(torch.from_numpy(q), chunks, 6, kernel=kernel,
                                 chunk_size=chunk_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    one = nw_log_probs(torch.from_numpy(q), torch.from_numpy(sf), torch.from_numpy(sy), 6,
                       kernel=kernel)
    torch.testing.assert_close(got, one, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="exceeds"):
        nw_streaming_log_probs(torch.from_numpy(q), chunks[::-1], 6, chunk_size=40)


# ---------------------------------------------------------------------------
# NWNet(mesh=...) and serve --mesh.
# ---------------------------------------------------------------------------

class _Tiny(nn.Module):
    """A linear featurizer: 8 x 8 x 3 images to 16 features."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8 * 8 * 3, 16)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(0)
            self.fc.weight.copy_(torch.randn(16, 192, generator=gen) * 0.2)
            self.fc.bias.zero_()

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1))


def _nets(head_precision="f32", **kwargs):
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=40, n_classes=4, size=8, seed=0)
    feat = _Tiny()
    nets = [NWNet(copy.deepcopy(feat), 4, support_dataset=ds, device="cpu", n_shot_full=5,
                  head_precision=head_precision, fused_min_support=1, mesh=mesh, **kwargs)
            for mesh in (make_mesh(2, 4, devices=CPU8), None)]
    for net in nets:
        net.precompute()
    return nets, ds.gather(np.arange(8))


def test_nwnet_mesh_full_mode_matches_unsharded():
    """Full mode through the sharded bank (raw shards on the CPU) equals the
    unsharded net's, by ``predict`` and by the serving callable; a new
    ``precompute`` rebuilds the sharded bank."""
    (sharded, alone), x = _nets()
    assert sharded.sharded_bank is not None and not sharded.sharded_bank.prepared
    assert sharded._prepared_full is None and alone.sharded_bank is None
    want = alone.predict(x, "full")
    torch.testing.assert_close(sharded.predict(x, "full"), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sharded.make_serving_fn()(x), want, rtol=1e-4, atol=1e-4)
    bank = sharded.sharded_bank
    sharded.precompute()
    assert sharded.sharded_bank is not bank


@pytest.mark.parametrize("head_precision", ["int8", "bf16"])
def test_nwnet_mesh_ivf_mode(head_precision):
    """A reduced-precision head builds prepared shards with a routing index:
    mode ``ivf`` at a probe count covering every tile equals the sharded
    full mode and the unsharded net's prepared head; the routed predict is
    cached per bank; ``ivf_n_probe='auto'`` is refused under a mesh."""
    (sharded, alone), x = _nets(head_precision, ivf_n_probe=64)
    assert sharded.sharded_bank.prepared and sharded.sharded_bank.ivf
    out = sharded.predict(x, "ivf")
    full = sharded.predict(x, "full")
    assert float((out.exp() - full.exp()).abs().max()) < 1e-5
    tol = _tol(head_precision)
    torch.testing.assert_close(full, alone.predict(x, "full"), rtol=tol, atol=tol)
    cached = sharded._ivf_cache
    torch.testing.assert_close(sharded.make_serving_fn(mode="ivf")(x), out, rtol=0, atol=0)
    assert sharded._ivf_cache is cached
    (auto, _), _ = _nets(head_precision, ivf_n_probe="auto")
    with pytest.raises(ValueError, match="single-device only"):
        auto.predict(x, "ivf")
    with pytest.raises(ValueError, match="single-device only"):
        auto.make_serving_fn(mode="ivf")


def test_nwnet_mesh_ivf_needs_a_routing_index():
    (sharded, _), x = _nets()
    with pytest.raises(ValueError, match="routing index"):
        sharded.predict(x, "ivf")


def test_serve_cli_mesh_on_cpu():
    """``serve --device cpu --mesh 2,2`` serves from two shards, the batch
    split over two data rows, and names the mesh in its report; a model
    axis (``--mesh 1,2,2``) serves from the first device of each model
    row."""
    from nwhead_tpu_torch import serve

    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
            "--latency_bench", "--bench_batches", "2", "--batch_size", "8", "--mesh", "2,2"]
    report = serve.main(argv)["latency"]
    assert report["mesh"] == {"data": 2, "support": 2, "model": 1}
    assert report["batches"] == 2 and report["p50_ms"] > 0
    report = serve.main(argv[:-1] + ["1,2,2"])["latency"]
    assert report["mesh"] == {"data": 1, "support": 2, "model": 2}
    assert report["batches"] == 2 and report["p50_ms"] > 0


# ---------------------------------------------------------------------------
# Queue 3, fault 2: the host path's eval padding.
# ---------------------------------------------------------------------------

class _HostOnly:
    """A dataset without an in-memory ``images`` array: its eval batches take
    the trainer's host path."""

    def __init__(self, ds):
        self._ds, self.targets, self.num_classes = ds, ds.targets, ds.num_classes

    def __len__(self):
        return len(self._ds)

    def gather(self, idx):
        return self._ds.gather(idx)


def test_host_eval_batches_pad_with_zero_images_as_jax():
    """The trainer's host path pads the tail batch with zero images, as the
    JAX package's ``_padded_eval_batches`` does (its device path pads with
    row 0 in both packages): the images ``predict`` receives equal JAX's."""
    from nwhead_tpu.train.trainer import _padded_eval_batches

    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.data.pipeline import device_images
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.train.trainer import NWTrainer

    val = _HostOnly(make_synthetic_dataset(n=11, n_classes=4, size=8, seed=1))
    assert device_images(val, "cpu") is None
    train = make_synthetic_dataset(n=16, n_classes=4, size=8, seed=0)
    net = NWNet(_Tiny(), 4, support_dataset=train, device="cpu")
    trainer = NWTrainer(net, train, val, batch_size=4, eval_modes=("random",))
    seen = []

    def predict(x, mode):
        seen.append(torch.as_tensor(x).numpy().copy())
        return torch.zeros(x.shape[0], 4)

    net.predict = predict
    trainer.eval_epoch("random")
    want = [img for img, _ in _padded_eval_batches(val, 4, None)]
    assert len(seen) == len(want) == 3
    for got, ref in zip(seen, want):
        np.testing.assert_array_equal(got, ref)
    assert not seen[-1][3:].any()


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_fused_partials_match_plain(precision):
    """K1 ``partials=True`` against its plain version: every kernel, masked
    rows holding NaN, an all-masked support; rtol=atol=2e-4 (bf16 2e-3)."""
    dev = _need_gpu()
    rng = np.random.default_rng(0)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    for B, S, D, C in ((8, 1200, 512, 200), (37, 1001, 64, 10)):
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        valid = rng.random(S) > 0.03
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        labels = torch.from_numpy(np.where(valid, rng.integers(0, C, S), -1)
                                  .astype(np.int32)).to(dev)
        for kernel in KERNELS:
            params = {"logit_scale": torch.tensor(LOGIT_SCALE, device=dev)} \
                if kernel == "clip" else {}
            mode, scale, qn, sn = tfused._resolve_mode(kernel, params, q.to(dt), s.to(dt))
            args = (qn.to(sn.dtype).contiguous(), sn.contiguous())
            for lab in (labels, torch.full_like(labels, -1)):
                before = tfused.nw_fwd_partials_cuda.launches
                got = tfused.nw_fwd_partials_cuda(*args, lab, scale, mode, C)
                want = tfused._nw_fwd_partials_plain(*args, lab, scale, mode, C)
                torch.cuda.synchronize()
                assert tfused.nw_fwd_partials_cuda.launches == before + 1
                tol = _tol(precision)
                torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=tol)
                for g, w in zip(got[1:], want[1:]):
                    assert torch.isfinite(g).all()
                    torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_prepared_partials_match_plain(precision):
    """K2/K4/K5 and K6 ``partials=True`` against their plain versions, a
    ``tile_sel`` with empty slots and one with none live; the merged
    partials equal the finalizing kernel's log-probs."""
    dev = _need_gpu()
    rng = np.random.default_rng(1)
    B, S, D, C = 64, 5994, 512, 200
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    sy = rng.integers(0, C, S)
    mask = torch.from_numpy((rng.random(S) > 0.03).astype(np.float32))
    quant = precision in ("int8", "int4")
    full = {"f32": tfused.nw_prepared_partials_cuda, "bf16": tfused.nw_prepared_partials_cuda,
            "int8": tfused.nw_prepared_partials_int8_cuda,
            "int4": tfused.nw_prepared_partials_int4_cuda}[precision]
    sel_fn = (tfused.nw_prepared_sel_partials_quant_cuda if quant
              else tfused.nw_prepared_sel_partials_cuda)
    tol = _tol(precision)
    for kernel in KERNELS:
        params = {"logit_scale": torch.tensor(LOGIT_SCALE, device=dev)} \
            if kernel == "clip" else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prep = tfused.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                          precision=precision, block_s=1024)
        qk, scale, mode, qscale = tfused._prepared_query(q, prep, kernel, params)
        args = (qk, prep, scale, mode, C, qscale)
        got = full(*args)
        want = tfused._nw_prepared_plain(*args, partials=True)
        for sel in ([3, -1, 0, 5, -1], [-1, -1]):
            tsel = torch.tensor(sel, dtype=torch.int32, device=dev)
            got_sel = sel_fn(*args, tsel)
            want_sel = tfused._nw_prepared_sel_plain(*args, tsel, partials=True)
            for g, w in zip(got_sel, want_sel):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        torch.testing.assert_close(merge_partials([got]),
                                   tfused.nw_fused_from_prepared(q, prep, C, kernel=kernel,
                                                                 kernel_params=params),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_sharded_bank_matches_unsharded(precision):
    """Four shards on one card (``[cuda:0] * 4``) against the unsharded
    prepared head; routed at full probe the same; streaming the bank from
    the host in chunks against it too (f32)."""
    dev = _need_gpu()
    from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs

    sf, sy, q = _bank(S=20_003, C=50, D=128, B=64, seed=11, clustered=True)
    qd = torch.from_numpy(q).to(dev)
    tol = _tol(precision)
    alone = tfused.nw_fused_from_prepared(
        qd, tfused.prepare_support(torch.from_numpy(sf).to(dev), sy, 50, precision=precision),
        50)
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    bank = ShardedSupportBank.build(torch.from_numpy(sf).to(dev), sy, mesh, 50,
                                    precision=precision, ivf=True)
    assert bank.prepared and bank.ivf
    torch.testing.assert_close(bank.predict_fn()(qd), alone, rtol=tol, atol=tol)
    torch.testing.assert_close(bank.predict_fn(ivf_n_probe=64)(qd), alone, rtol=tol, atol=tol)
    if precision == "f32":
        chunks = [(sf[i:i + 4096], sy[i:i + 4096]) for i in range(0, len(sf), 4096)]
        before = tfused.nw_fwd_partials_cuda.launches
        got = nw_streaming_log_probs(qd, chunks, 50)
        assert tfused.nw_fwd_partials_cuda.launches == before + len(chunks)
        torch.testing.assert_close(got, alone, rtol=2e-4, atol=2e-4)
