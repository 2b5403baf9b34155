"""K1 and K3's dq pass on the tensor cores over raw support rows
(``csrc/nw_prepared.cu`` ``nw_raw_forward``, ``csrc/nw_fused.cu``
``nw_raw_dq_tc_kernel``): their plan, and the l2 recipe that keeps a
coincident pair's distance exactly 0.

The plan (query tile, split count, shared-memory bytes) is a pure function
of the shapes, checked here at the training episode (B = 8, S = 1,200), at
B = 64 over the CUB bank's S = 5,994 and at a streamed chunk (B = 64,
65,536 rows, C = 1,000); a ``gpu`` test holds the wrapper's byte counts to
the library's. The recipe is emulated in plain torch: the kernel's 3xTF32
split (big and small parts rounded to TF32, ``split_rna``), products summed
from zero over each slice of 128 bytes of features (at a query tile of 16
or fewer, each half of the slice apart, the halves added last), and
``|q|^2`` and ``|s|^2`` taken by the very same function as ``q.s``. A query
copied into the support then has ``q2 - 2 q.s + s2`` exactly 0, where the
plain f32 sums leave rounding residue; the other distances stay within
2e-4 of the plain version in f64. The JAX-parity tests of the plain
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


# -- the l2 recipe, emulated ------------------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest, ties away from zero (the kernel's
    ``split_rna``: add half an ulp of TF32 to the bits, clear 13 bits)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tc_products(a: torch.Tensor, b: torch.Tensor, chunk: int, split_k: bool) -> torch.Tensor:
    """``a (Na, D) . b (Nb, D)`` by the kernel's route: f32 as 3xTF32 (big x
    big, big x small, small x big; the small parts rounded to TF32 too),
    bf16 as its exact products; each slice of ``chunk`` features (or each
    half of it at ``split_k``) summed from zero in f32, then added to its
    running sum; at ``split_k`` the two halves' sums added last, half 0
    first. Every output element takes the same sequence of operations, as
    the tensor cores' outputs do wherever they sit in a tile."""
    f32 = a.dtype == torch.float32
    af, bf = a.float(), b.float()
    if f32:
        ab, bb = _tf32_rna(af), _tf32_rna(bf)
        a_s, b_s = _tf32_rna(af - ab), _tf32_rna(bf - bb)
    D = a.shape[1]
    depth = chunk // 2 if split_k else chunk
    halves = []
    for h in range(2 if split_k else 1):
        acc = torch.zeros(a.shape[0], b.shape[0])
        for c0 in range(0, D, chunk):
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


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_raw_smem_matches_the_plan():
    """K1's block is K2's (one kernel), dq's is the size the wrapper plans
    with, at every query tile and the main paths' widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    from nwhead_tpu_torch.ops import _cuda

    lib, fused = _cuda.load_library(), _cuda.load_library("nw_fused")
    for qb in (8, 16, 32):
        for C in (200, 1000):
            assert lib.nw_prepared_tc_smem_bytes(qb, C, 0) == tfused._tc_smem_bytes(qb, C, False)
        for D in (3, 33, 384, 512, 2048):
            assert fused.nw_fused_dq_smem_bytes(qb, D) == tfused._dq_smem_bytes(qb, D)
    optin = tfused._smem_optin(lib, torch.device("cuda"))
    assert fused.nw_fused_dq_max_features(0) == (optin - tfused._dq_smem_bytes(8, 0)) // 32


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_raw_kernels_repeat_bit_for_bit(precision):
    """Two calls of K1 (finalizing and ``partials``) and of dq on the same
    inputs give the same bits (no float atomics), at the episode's and the
    streamed chunk's shapes (unsorted labels, NaN in masked rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    dev = torch.device("cuda")
    for B, S, D, C in ((8, 1200, 512, 200), (64, 65_536, 512, 1000)):
        rng = np.random.default_rng(S)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev, dtype)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev, dtype)
        valid = rng.random(S) > 0.03
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        labels = torch.from_numpy(
            np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
        scale = torch.ones(1, device=dev)
        args = (q, s, labels, scale, "l2", C)
        for fn in (tfused.nw_fwd_cuda, tfused.nw_fwd_partials_cuda):
            a, b = fn(*args), fn(*args)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        out, m, l = tfused.nw_fwd_cuda(*args)
        g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
        u = (g * torch.exp(-out)).contiguous()
        r = torch.sum(u * (torch.exp(out) - 1e-12), dim=-1, keepdim=True)
        bwd = (q, s, labels, u, r, m, l, scale, "l2", C)
        assert torch.equal(tfused.nw_bwd_dq_cuda(*bwd), tfused.nw_bwd_dq_cuda(*bwd))
