"""K1 and K3's dq and ds passes on the tensor cores over raw support rows
(``csrc/nw_prepared.cu`` ``nw_raw_forward``, ``csrc/nw_fused.cu``
``nw_raw_dq_tc_kernel``, ``nw_raw_ds_tc_kernel``): their plan, and the l2
recipe that keeps a coincident pair's distance exactly 0.

The plan (query tile, split count, shared-memory bytes) is a pure function
of the shapes, checked here at the training episode (B = 8, S = 1,200), at
B = 64 over the CUB bank's S = 5,994 and at a streamed chunk (B = 64,
65,536 rows, C = 1,000); a ``gpu`` test holds the wrapper's byte counts to
the library's; ds's plan (query tile, cluster, query group) at the same
shapes. The recipe is emulated in plain torch: the kernel's 3xTF32
split (big and small parts rounded to TF32, ``split_rna``), products summed
from zero over each slice of 128 bytes of features (at a query tile of 16
or fewer, each half of the slice apart, the halves added last), and
``|q|^2`` and ``|s|^2`` taken by the very same function as ``q.s``. A query
copied into the support then has ``q2 - 2 q.s + s2`` exactly 0, where the
plain f32 sums leave rounding residue; the other distances stay within
2e-4 of the plain version in f64. ds's recipe adds the blocks of a
cluster (each its share of the slices, their partials added in rank
order) and ``t^T q`` with t split as big + small TF32: a coincident pair
gets ``t = 0`` and ds stays within 2e-4 of the f64 plain version. The JAX-parity tests of the plain
versions are in ``tests/test_torch_fused_train.py`` and
``tests/test_torch_sharded.py``. The kernels themselves are held to their
plain versions on the card (marker ``gpu``): ``python -m pytest
--noconftest -m gpu tests/test_torch_raw_tc.py
tests/test_torch_fused_train.py``.
"""

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused

torch.set_num_threads(1)

# (name, B, S, D, C): the raw route's shapes on the main paths.
RAW_PLAN = [
    ("episode", 8, 1200, 512, 200),
    ("b64", 64, 5994, 512, 200),
    ("stream_chunk", 64, 65_536, 512, 1000),
    ("vit_episode", 8, 1200, 384, 200),
]
H100_SMS = 132


@pytest.mark.parametrize("case", RAW_PLAN, ids=[c[0] for c in RAW_PLAN])
def test_raw_forward_plan(case):
    """K1 takes K2's plan: 8 queries a block at the episode (one query
    tile, split-K halves), 32 at B = 64; one wave of whole-tile splits (19
    at the episode, 47 at B = 64, 64 on a streamed chunk); its block fits
    the H100's shared memory."""
    _, B, S, D, C = case
    optin = tfused.H100_SMEM_OPTIN
    qb = tfused._tc_query_tile(B, C, False, optin)
    assert qb == (8 if B == 8 else 32)
    assert tfused._tc_smem_bytes(qb, C, False) <= optin
    rows, n_splits = tfused._tc_splits(S, -(-B // qb), H100_SMS)
    want = {"episode": (64, 19), "vit_episode": (64, 19), "b64": (128, 47),
            "stream_chunk": (1024, 64)}[case[0]]
    assert (rows, n_splits) == want
    assert rows % 64 == 0 and n_splits * rows >= S > (n_splits - 1) * rows


@pytest.mark.parametrize("case", RAW_PLAN, ids=[c[0] for c in RAW_PLAN])
def test_raw_dq_plan(case):
    """dq's query tile follows B and D (8 at the episode, 32 at B = 64),
    its block (a 6-stage ring, t, and sum_j t s_j for its queries at D + 8
    floats a row) fits the H100's shared memory, and its splits are K1's
    rule over its own query tiles."""
    _, B, S, D, C = case
    optin = tfused.H100_SMEM_OPTIN
    qb = tfused._dq_query_tile(B, D, optin)
    assert qb == (8 if B == 8 else 32)
    smem = tfused._dq_smem_bytes(qb, D)
    assert smem <= optin
    stage = (max(qb, 16) + 64) * 128 + 1024
    assert smem == 1024 + 6 * stage + 4 * ((2 if qb <= 16 else 1) * qb * 68
                                           + max(qb, 16) * 68 + 160) + 96 + 4 * qb * (D + 8)
    rows, n_splits = tfused._tc_splits(S, -(-B // qb), H100_SMS)
    assert n_splits * rows >= S and rows % 64 == 0


def test_dq_query_tile_shrinks_with_d_and_refuses_past_its_cap():
    """A wide D takes a smaller query tile; past the 8-query block's cap
    the wrapper's plan refuses, as the library does."""
    optin = tfused.H100_SMEM_OPTIN
    assert tfused._dq_query_tile(64, 1024, optin) == 32
    assert tfused._dq_query_tile(64, 2048, optin) == 16
    cap8 = (optin - tfused._dq_smem_bytes(8, 0)) // 32
    assert tfused._dq_query_tile(8, cap8, optin) == 8
    with pytest.raises(ValueError, match="D="):
        tfused._dq_query_tile(8, cap8 + 1, optin)


@pytest.mark.parametrize("case", RAW_PLAN, ids=[c[0] for c in RAW_PLAN])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_raw_ds_plan(case, precision):
    """ds's plan: 8 queries a tile at the episode, 16 at B = 64 (split-K
    halves at both); a cluster of 4 blocks on each of the episode's 19 tiles (76
    blocks, one wave) and 1 where the tiles alone fill a wave; every
    query of the batch in one group; the block (a 6-stage ring, the
    exchanged partials, t at 72 floats a row) within the H100's shared
    memory."""
    name, B, S, D, C = case
    elem = 4 if precision == "f32" else 2
    optin = tfused.H100_SMEM_OPTIN
    qb, cluster, group = tfused._ds_plan(B, S, D, elem, optin, H100_SMS)
    assert qb == (8 if B == 8 else 16)
    assert cluster == (4 if -(-S // 64) * 4 <= H100_SMS else 1)
    assert group == B
    smem = tfused._ds_smem_bytes(qb, cluster, group)
    assert smem <= optin
    stage = max((max(qb, 16) + 64) * 128 + 1024, 128 * 128)
    part = (2 if qb <= 16 else 1) * qb * 68 + 160
    assert smem == (1024 + 6 * stage + 112 + 4 * ((2 * cluster if cluster > 1 else 1) * part
                                                  + -(-group // 32) * 32 * 72 + 128) + 256)


def test_ds_plan_clusters_follow_the_slices_and_the_wave():
    """A cluster never outnumbers D's slices of 128 bytes (D = 33 f32 is
    two slices: 2 blocks; D = 3 one: none), and shrinks as the tiles fill
    the SMs (34 tiles x 4 > 132: 2; 67 tiles: 1)."""
    optin = tfused.H100_SMEM_OPTIN
    assert tfused._ds_plan(8, 1200, 33, 4, optin, H100_SMS)[1] == 2
    assert tfused._ds_plan(8, 1200, 3, 4, optin, H100_SMS)[1] == 1
    assert tfused._ds_plan(8, 34 * 64, 512, 4, optin, H100_SMS)[1] == 2
    assert tfused._ds_plan(8, 67 * 64, 512, 4, optin, H100_SMS)[1] == 1
    assert tfused._ds_plan(16, 1200, 512, 2, optin, H100_SMS)[0] == 16


@pytest.mark.parametrize("B", [449, 848, 5000])
def test_ds_plan_has_no_batch_cap_and_refuses_past_dq_features(B):
    """Past the t buffer's rows the batch runs in query groups (a multiple
    of 64, the block still within the card's shared memory), so B has no
    cap (the FFMA kernel's was 848 on an H100); D is held to dq's cap, the
    backward's, and the plan refuses past it, naming D."""
    optin = tfused.H100_SMEM_OPTIN
    qb, cluster, group = tfused._ds_plan(B, 1200, 512, 4, optin, H100_SMS)
    assert group < B and group % 64 == 0 and group >= 64
    assert tfused._ds_smem_bytes(qb, cluster, group) <= optin
    assert tfused._ds_smem_bytes(qb, cluster, group + 64) > optin
    cap8 = (optin - tfused._dq_smem_bytes(8, 0)) // 32
    assert tfused._ds_plan(8, 1200, cap8, 4, optin, H100_SMS)[0] == 8
    with pytest.raises(ValueError, match=f"D={cap8 + 1} is beyond the backward's cap of {cap8}"):
        tfused._ds_plan(8, 1200, cap8 + 1, 4, optin, H100_SMS)


# -- the l2 recipe, emulated ------------------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest, ties away from zero (the kernel's
    ``split_rna``: add half an ulp of TF32 to the bits, clear 13 bits)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tc_products(a: torch.Tensor, b: torch.Tensor, chunk: int, split_k: bool,
                 slices: range = None) -> torch.Tensor:
    """``a (Na, D) . b (Nb, D)`` by the kernel's route: f32 as 3xTF32 (big x
    big, big x small, small x big; the small parts rounded to TF32 too),
    bf16 as its exact products; each slice of ``chunk`` features (or each
    half of it at ``split_k``) summed from zero in f32, then added to its
    running sum; at ``split_k`` the two halves' sums added last, half 0
    first. Every output element takes the same sequence of operations, as
    the tensor cores' outputs do wherever they sit in a tile. ``slices``
    (default all) is the block's share of them, as ds's cluster splits
    them."""
    f32 = a.dtype == torch.float32
    af, bf = a.float(), b.float()
    if f32:
        ab, bb = _tf32_rna(af), _tf32_rna(bf)
        a_s, b_s = _tf32_rna(af - ab), _tf32_rna(bf - bb)
    D = a.shape[1]
    slices = range(-(-D // chunk)) if slices is None else slices
    depth = chunk // 2 if split_k else chunk
    halves = []
    for h in range(2 if split_k else 1):
        acc = torch.zeros(a.shape[0], b.shape[0])
        for c0 in (k * chunk for k in slices):
            lo = hi = torch.zeros_like(acc)
            for k in range(c0 + h * depth, min(c0 + (h + 1) * depth, D)):
                if f32:
                    lo = lo + a_s[:, k, None] * bb[None, :, k]
                    lo = lo + ab[:, k, None] * b_s[None, :, k]
                    hi = hi + ab[:, k, None] * bb[None, :, k]
                else:
                    hi = hi + af[:, k, None] * bf[None, :, k]
            acc = acc + (hi + lo)
        halves.append(acc)
    return halves[0] + halves[1] if split_k else halves[0]


def _recipe_dist(q, s, qb):
    """The kernel's l2 distances ``(B, S)``: q.s, |q|^2 and |s|^2 all from
    ``_tc_products`` (the self-norms as diagonals), at query tile ``qb``."""
    chunk = 128 // q.element_size()
    split_k = qb <= 16
    dot = _tc_products(q, s, chunk, split_k)
    q2 = torch.diagonal(_tc_products(q, q, chunk, split_k))
    s2 = torch.diagonal(_tc_products(s, s, chunk, split_k))
    return torch.sqrt(torch.clamp(q2[:, None] - 2.0 * dot + s2[None, :], min=0.0))


@pytest.mark.parametrize("D", [512, 384, 33])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("qb", [8, 32])
def test_self_products_keep_coincident_pairs_at_zero(D, precision, qb):
    """Queries copied into the support: by the recipe, every coincident
    pair's distance is exactly 0 (at both the split-K query tile and the
    32-query one), the rest within 2e-4 of the plain version in f64, on
    ReLU features (one sign, where rounding errors add up).
    On f32 features the plain sums (``|q|^2`` and ``|s|^2`` by
    ``torch.sum``) leave residue on some coincident pair."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    rng = np.random.default_rng(D + qb)
    B, S = 8, 24
    q = torch.from_numpy(np.maximum(rng.standard_normal((B, D)), 0).astype(np.float32)).to(dtype)
    s = torch.from_numpy(np.maximum(rng.standard_normal((S, D)), 0).astype(np.float32)).to(dtype)
    rows = rng.choice(S, 6, replace=False)
    s[torch.from_numpy(rows)] = q[:6]
    dist = _recipe_dist(q, s, qb)
    assert (dist[torch.arange(6), torch.from_numpy(rows)] == 0).all()
    want = torch.cdist(q.double(), s.double())
    other = torch.ones_like(dist, dtype=torch.bool)
    other[torch.arange(6), torch.from_numpy(rows)] = False
    torch.testing.assert_close(dist[other].double(), want[other], rtol=2e-4, atol=2e-4)
    if precision == "bf16":
        return  # bf16 products are exact in f32: short plain sums may leave no residue
    qf, sf = q.float(), s.float()
    plain = torch.sum(qf * qf, 1)[:, None] - 2.0 * qf @ sf.T + torch.sum(sf * sf, 1)[None, :]
    assert (plain[torch.arange(6), torch.from_numpy(rows)] != 0).any()


def _split_tf32(x: torch.Tensor):
    """x = big + small, both rounded to TF32 (the kernel's ``split_rna``)."""
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _recipe_ds(q, s, labels, u, r, m, l, qb, n_ranks):
    """ds by the kernel's recipe in l2 mode: ``(dist (B, S), t (B, S), ds (S,
    D))``. Each of ``n_ranks`` blocks takes slices [k nK / n, (k + 1) nK /
    n) of the nK; its partial q.s, |q|^2 and |s|^2 come from
    ``_tc_products`` over them, and the partials are added in rank order
    (from 0, as the kernel adds them); t in f32 as the kernel takes it;
    then ``t^T q`` with t split as big + small TF32 and f32 q as well
    (three products, each stage of 64 queries summed from zero and added
    to the slice's sum; a bf16 q is its own big part: two products, added
    to the sum as they come), less ``s_j sum_b t_bj``. Masked rows get
    ds = 0."""
    chunk = 128 // q.element_size()
    split_k = qb <= 16
    nk = -(-q.shape[1] // chunk)
    dot = q2 = s2 = 0.0
    for k in range(n_ranks):
        own = range(k * nk // n_ranks, (k + 1) * nk // n_ranks)
        dot = dot + _tc_products(q, s, chunk, split_k, own)
        q2 = q2 + torch.diagonal(_tc_products(q, q, chunk, split_k, own))
        s2 = s2 + torch.diagonal(_tc_products(s, s, chunk, split_k, own))
    dist = torch.sqrt(torch.clamp(q2[:, None] - 2.0 * dot + s2[None, :], min=0.0))
    score = -dist
    m_safe = torch.where(m > -3e38, m, 0.0)
    w = torch.exp(score - m_safe) / torch.clamp(l, min=1e-30)
    valid = labels >= 0
    dscore = w * (u[:, labels.clamp(min=0).long()] - r)
    t = torch.where(valid[None, :] & (dist > 0), dscore / torch.where(dist > 0, dist, 1.0), 0.0)
    t_big, t_small = _split_tf32(t)
    qf = q.float()
    q_big, q_small = _split_tf32(qf) if q.dtype == torch.float32 else (qf, None)
    acc = torch.zeros(s.shape[0], q.shape[1])
    for b0 in range(0, q.shape[0], 64):
        rows = slice(b0, b0 + 64)
        lo = t_small[rows].T @ q_big[rows]
        if q_small is None:
            acc = acc + lo + t_big[rows].T @ q_big[rows]
        else:
            lo = lo + t_big[rows].T @ q_small[rows]
            acc = acc + (t_big[rows].T @ q_big[rows] + lo)
    sf = torch.where(valid[:, None], s.float(), 0.0)
    ds = torch.where(valid[:, None], acc - sf * torch.sum(t, dim=0)[:, None], 0.0)
    return dist, t, ds


@pytest.mark.parametrize("n_ranks", [1, 4])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("qb", [8, 32])
def test_ds_recipe_keeps_coincident_pairs_at_zero(qb, precision, n_ranks):
    """ds's recipe on ReLU features with queries copied into the support
    and a masked row holding NaN, alone or in a cluster of 4: every
    coincident pair's distance, and so its t, is exactly 0; ds stays within
    2e-4 (of max|ds|) of the plain version in f64 and is 0 on the masked
    row."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    rng = np.random.default_rng(7 * qb + n_ranks)
    B, S, D, C = 8, 20, 512, 5
    q = torch.from_numpy(np.maximum(rng.standard_normal((B, D)), 0).astype(np.float32)).to(dtype)
    s = torch.from_numpy(np.maximum(rng.standard_normal((S, D)), 0).astype(np.float32)).to(dtype)
    rows = torch.from_numpy(rng.choice(S - 1, 6, replace=False))
    s[rows] = q[:6]
    s[S - 1] = float("nan")
    labels = torch.from_numpy(rng.integers(0, C, size=S).astype(np.int32))
    labels[S - 1] = -1
    scale = torch.ones(1)
    out, m, l = tfused._nw_fwd_plain(q.double(), s.double(), labels, scale, "l2", C)
    g = torch.from_numpy(rng.standard_normal((B, C)))
    u = g * torch.exp(-out)
    r = torch.sum(u * (torch.exp(out) - 1e-12), dim=-1, keepdim=True)
    u, r, m, l = (x.float() for x in (u, r, m, l))
    dist, t, ds = _recipe_ds(q, s, labels, u, r, m, l, qb, n_ranks)
    pairs = (torch.arange(6), rows)
    assert (dist[pairs] == 0).all() and (t[pairs] == 0).all()
    assert (ds[S - 1] == 0).all()
    want = tfused._nw_bwd_ds_plain(q.double(), s.double(), labels, u.double(), r.double(),
                                   m.double(), l.double(), scale, "l2", C)
    assert float((ds.double() - want).abs().max() / want.abs().max()) <= 2e-4


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_raw_smem_matches_the_plan():
    """K1's block is K2's (one kernel), dq's and ds's are the sizes the
    wrapper plans with, at every query tile, cluster and the main paths'
    widths; ds's largest query group is the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    from nwhead_tpu_torch.ops import _cuda

    lib, fused = _cuda.load_library(), _cuda.load_library("nw_fused")
    optin = tfused._smem_optin(lib, torch.device("cuda"))
    for qb in (8, 16, 32):
        for C in (200, 1000):
            assert lib.nw_prepared_tc_smem_bytes(qb, C, 0) == tfused._tc_smem_bytes(qb, C, False)
        for D in (3, 33, 384, 512, 2048):
            assert fused.nw_fused_dq_smem_bytes(qb, D) == tfused._dq_smem_bytes(qb, D)
        for cluster in (1, 2, 4):
            for group in (1, 8, 37, 64, 256):
                assert (fused.nw_fused_ds_smem_bytes(qb, cluster, group)
                        == tfused._ds_smem_bytes(qb, cluster, group))
            fixed = tfused._ds_smem_bytes(qb, cluster, 0)
            assert fused.nw_fused_ds_max_group(qb, cluster, 0) == (optin - fixed) // 288 // 64 * 64
    assert fused.nw_fused_dq_max_features(0) == (optin - tfused._dq_smem_bytes(8, 0)) // 32
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    qb, cluster, group = tfused._ds_plan(900, 1200, 512, 4, optin, n_sms)
    assert group == fused.nw_fused_ds_max_group(qb, cluster, 0) < 900


def _raw_inputs(B, S, D, C, dtype, seed, dev, mode="l2", scale=1.0):
    """Query and support rows N(0, 1) in ``dtype`` with 3% of the rows
    masked (NaN), labels, and the backward's ``(u, r, m, l)`` from the
    plain forward in ``mode`` on a random upstream gradient; the last item
    is the similarity scale."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev, dtype)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev, dtype)
    valid = rng.random(S) > 0.03
    valid[0] = True
    s[torch.from_numpy(~valid).to(dev)] = float("nan")
    labels = torch.from_numpy(
        np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
    scale = torch.full((1,), scale, device=dev)
    out, m, l = tfused._nw_fwd_plain(q, s, labels, scale, mode, C)
    g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
    u = (g * torch.exp(-out)).contiguous()
    r = torch.sum(u * (torch.exp(out) - 1e-12), dim=-1, keepdim=True)
    return q, s, labels, u, r, m, l, scale


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_raw_kernels_repeat_bit_for_bit(precision):
    """Two calls of K1 (finalizing and ``partials``), of dq and of ds on the
    same inputs give the same bits (no float atomics; ds's cluster adds its
    partials in rank order), at the episode's and the streamed chunk's
    shapes (unsorted labels, NaN in masked rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    dev = torch.device("cuda")
    for B, S, D, C in ((8, 1200, 512, 200), (64, 65_536, 512, 1000)):
        q, s, labels, u, r, m, l, scale = _raw_inputs(B, S, D, C, dtype, S, dev)
        args = (q, s, labels, scale, "l2", C)
        for fn in (tfused.nw_fwd_cuda, tfused.nw_fwd_partials_cuda):
            a, b = fn(*args), fn(*args)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        out, m, l = tfused.nw_fwd_cuda(*args)
        bwd = (q, s, labels, u, r, m, l, scale, "l2", C)
        assert torch.equal(tfused.nw_bwd_dq_cuda(*bwd), tfused.nw_bwd_dq_cuda(*bwd))
        assert torch.equal(tfused.nw_bwd_ds_cuda(*bwd), tfused.nw_bwd_ds_cuda(*bwd))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("qb", [8, 16, 32])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_cuda_ds_every_plan_matches_plain(cluster, qb, precision):
    """ds at every query tile and cluster (the plan picks one; the others
    are what the lab compares), one query group and groups of 64 through
    the f32 scratch, l2 and dot mode, at B = 70 (two or more query tiles
    and stages of t^T q, the last ragged) over 1,001 rows (the last tile
    ragged) and D = 392 (f32: 13 slices, one a partial; bf16: 7), against
    the plain version within 1e-3 (f32) or 2e-2 (bf16) of max|plain|,
    masked rows (NaN) at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    rel = {"f32": 1e-3, "bf16": 2e-2}[precision]
    dev = torch.device("cuda")
    B, S, D, C = 70, 1001, 392, 30
    for mode, scale in (("l2", 1.0), ("dot", 0.07)):
        q, s, labels, u, r, m, l, sc = _raw_inputs(B, S, D, C, dtype, qb + cluster, dev, mode,
                                                   scale)
        want = tfused._nw_bwd_ds_plain(q, s, labels, u, r, m, l, sc, mode, C).float()
        for group in (B, 64):
            got = tfused._ds_launch(q, s, labels, u, r, m, l, sc, mode, C,
                                    plan=(qb, cluster, group)).float()
            torch.cuda.synchronize()
            assert torch.isfinite(got).all() and (got[labels < 0] == 0).all()
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= rel, (mode, group, err)
