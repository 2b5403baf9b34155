"""The port's prepared serving head against the JAX package.

``prepare_support`` must give the same row order, self-norms (1e30 on
masked rows) and labels as the JAX package; the plain PyTorch head over it
must match JAX's ``nw_fused_from_prepared``, whose Pallas kernel runs here in
interpret mode. Tolerances: f32 rtol=atol=2e-4, the bound the JAX kernel is
held to against its naive op; bf16 atol=5e-3 (both round the same inputs to
bf16 and differ in f32 summation order and the rounding of normalization).
The CUDA kernel itself is tested on the card only (marker ``gpu``). The
GPU machine has no jax, so this module imports the JAX package inside the
tests that compare with it, and the GPU test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_nw.py``.
"""

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=5e-3)}
# (B, S, D, C): C <= 128 keeps input order; C > 128 sorts rows by class.
CASES = {"c7": (5, 300, 40, 7), "c150": (5, 400, 24, 150),
         "d384": (4, 200, 384, 9),  # ViT-S/14's feature width
         "c1000": (5, 2000, 24, 1000)}  # the million-row bank's class count


def _inputs(case, seed=0):
    B, S, D, C = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    mask = (rng.random(S) > 0.1).astype(np.float32)
    return q, s, sy, mask, C


def _jax():
    """The JAX reference: ``(jax.numpy, nwhead_tpu.ops.pallas_nw)``."""
    import jax.numpy as jnp

    from nwhead_tpu.ops import pallas_nw

    return jnp, pallas_nw


def _params(kernel):
    if kernel != "clip":
        return None, None
    jnp, _ = _jax()
    return {"logit_scale": jnp.float32(1.3)}, {"logit_scale": torch.tensor(1.3)}


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", ["euclidean", "cosine"])
def test_prepare_support_matches_jax(kernel, case, precision):
    jnp, jfused = _jax()
    q, s, sy, mask, C = _inputs(case)
    S, D = s.shape
    jp, jorder = jfused.prepare_support(
        jnp.asarray(s), jnp.asarray(sy), C, kernel=kernel,
        support_mask=jnp.asarray(mask), precision=precision, return_order=True)
    tp, torder = tfused.prepare_support(
        torch.from_numpy(s), torch.from_numpy(sy), C, kernel=kernel,
        support_mask=torch.from_numpy(mask), precision=precision, return_order=True)
    if C > 128:
        assert torder is not None and np.array_equal(torder, jorder)
    else:
        assert torder is None and jorder is None
    order = np.arange(S) if torder is None else torder
    np.testing.assert_array_equal(tp.labels.numpy(), _f32(jp.lane).reshape(-1)[:S])
    np.testing.assert_array_equal(tp.labels.numpy() >= 0, mask[order] > 0)
    assert tp.s.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    # Normalization may round one ulp apart between XLA and torch.
    ulp = 2.0 ** -7 if precision == "bf16" else 1e-6
    np.testing.assert_allclose(tp.s.float().numpy(), _f32(jp.s)[:S, :D], rtol=ulp, atol=1e-7)
    if kernel == "euclidean":
        js2 = _f32(jp.s2c).reshape(-1)[:S]
        np.testing.assert_allclose(tp.s2.numpy(), js2, rtol=1e-6)
        assert (tp.s2.numpy()[mask[order] == 0] == 1e30).all()
    else:
        assert tp.s2 is None and jp.s2c is None


def test_masked_nan_rows_are_zeroed():
    """A masked row may hold NaN; the prepared bank zeroes it (where, not
    multiply) and the head stays finite and equal to JAX's."""
    jnp, jfused = _jax()
    q, s, sy, mask, C = _inputs("c7", seed=1)
    s[mask == 0] = np.nan
    tp = tfused.prepare_support(torch.from_numpy(s), torch.from_numpy(sy), C,
                                support_mask=torch.from_numpy(mask))
    assert torch.isfinite(tp.s).all() and torch.isfinite(tp.s2).all()
    assert (tp.s[torch.from_numpy(mask == 0)] == 0).all()
    got = tfused.nw_fused_from_prepared(torch.from_numpy(q), tp, C).numpy()
    jp = jfused.prepare_support(jnp.asarray(s), jnp.asarray(sy), C,
                                support_mask=jnp.asarray(mask))
    want = np.asarray(jfused.nw_fused_from_prepared(jnp.asarray(q), jp, C))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL["f32"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_plain_head_matches_jax_prepared(kernel, case, precision):
    """Plain PyTorch ``nw_fused_from_prepared`` vs JAX's Pallas kernel in
    interpret mode, ragged B=5, masked rows."""
    jnp, jfused = _jax()
    q, s, sy, mask, C = _inputs(case, seed=2)
    jparams, tparams = _params(kernel)
    jp = jfused.prepare_support(jnp.asarray(s), jnp.asarray(sy), C, kernel=kernel,
                                support_mask=jnp.asarray(mask), precision=precision)
    want = np.asarray(jfused.nw_fused_from_prepared(
        jnp.asarray(q), jp, C, kernel=kernel, kernel_params=jparams))
    tp = tfused.prepare_support(torch.from_numpy(s), torch.from_numpy(sy), C, kernel=kernel,
                                support_mask=torch.from_numpy(mask), precision=precision)
    got = tfused.nw_fused_from_prepared(torch.from_numpy(q), tp, C, kernel=kernel,
                                        kernel_params=tparams).numpy()
    assert got.shape == (q.shape[0], C) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[precision])


def test_prepare_support_rejects_what_is_not_ported():
    s = torch.zeros(4, 3)
    sy = torch.tensor([0, 1, 0, 1])
    for precision in ("int2", "fp8"):
        with pytest.raises(ValueError, match="unknown precision"):
            tfused.prepare_support(s, sy, 2, precision=precision)
    with pytest.raises(ValueError, match="out of range"):
        tfused.prepare_support(s, sy, 1)
    with pytest.raises(NotImplementedError):
        tfused.nw_fused_from_prepared(s[:1], tfused.prepare_support(s, sy, 2), 2,
                                      kernel="relation")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it never
    computes on the CPU."""
    prep = tfused.prepare_support(torch.zeros(4, 3), torch.tensor([0, 1, 0, 1]), 2)
    scale = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.nw_prepared_cuda(torch.zeros(2, 3), prep, scale, "l2", 2)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 5994, 512, 200), (37, 5994, 512, 10), (1, 1, 3, 1),
                                   (17, 65, 33, 129), (300, 1000, 100, 7),
                                   (64, 5800, 384, 200), (64, 20_000, 512, 1000),
                                   (37, 3001, 509, 1000), (8, 700, 40, 3377)])
def test_cuda_kernel_matches_plain(precision, shape):
    """On the card: the CUDA kernel vs the plain version, all five kernels,
    masked rows, at the CUB-200 shape, at the ViT-S/14 bank's (D=384), at
    C = 1,000 and the largest C served, and at ragged ones (D off the
    feature slice, S off the 64-row tile, one row, one class); f32
    rtol=atol=2e-4, bf16 atol=2e-3. At C > 128 both a class-sorted bank
    and a ``keep_order=True`` one, finalizing and ``partials=True``; two
    calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    tol = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}[precision]
    B, S, D, C = shape
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    sy = rng.integers(0, C, size=S)
    mask = torch.from_numpy((rng.random(S) > 0.03).astype(np.float32))
    mask[0] = 1.0
    for kernel in KERNEL_NAMES:
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        for keep_order in (False, True) if C > 128 else (False,):
            prep = tfused.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                          precision=precision, keep_order=keep_order)
            mode, scale, qn, _ = tfused._resolve_mode(kernel, params, q)
            qc = qn.to(prep.s.dtype)
            before = tfused.nw_prepared_cuda.launches
            got = tfused.nw_prepared_cuda(qc, prep, scale, mode, C)
            again = tfused.nw_prepared_cuda(qc, prep, scale, mode, C)
            want = tfused._nw_prepared_plain(qc, prep, scale, mode, C)
            torch.cuda.synchronize()
            assert tfused.nw_prepared_cuda.launches == before + 2
            torch.testing.assert_close(got, want, **tol)
            assert torch.equal(got, again)
            if C > 128:
                parts = tfused.nw_prepared_partials_cuda(qc, prep, scale, mode, C)
                plain = tfused._nw_prepared_plain(qc, prep, scale, mode, C, partials=True)
                for g, w in zip(parts, plain):
                    torch.testing.assert_close(g, w, rtol=tol["atol"], atol=tol["atol"])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_kernel_matches_plain_on_relu_features(precision):
    """On the card: features of one sign and a large shared component, as a
    ReLU featurizer gives (its distances cancel most of |q|^2 + |s|^2), at
    the serving bank's shape, euclidean: a product error that leans one way
    (truncated TF32 operands, long tensor-core sums) shows here, not on
    Gaussian features. f32 rtol=atol=2e-4, bf16 atol=2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    tol = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}[precision]
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    B, S, D = 64, 5800, 512
    base = 4.0 * np.abs(rng.standard_normal(D)).astype(np.float32)
    q = torch.from_numpy(base + 0.5 * np.abs(rng.standard_normal((B, D), np.float32))).to(dev)
    s = torch.from_numpy(base + 0.5 * np.abs(rng.standard_normal((S, D), np.float32))).to(dev)
    C = 200
    sy = rng.integers(0, C, size=S)
    prep = tfused.prepare_support(s, sy, C, precision=precision)
    mode, scale, qn, _ = tfused._resolve_mode("euclidean", {}, q)
    qc = qn.to(prep.s.dtype)
    got = tfused.nw_prepared_cuda(qc, prep, scale, mode, C)
    want = tfused._nw_prepared_plain(qc, prep, scale, mode, C)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take():
    """A class count beyond the shared-memory accumulator, or a query whose
    dtype is not the bank's, raises; nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    dev = torch.device("cuda")
    prep = tfused.prepare_support(torch.randn(70, 8, device=dev), np.arange(70) % 5, 100_000)
    scale = torch.ones(1, device=dev)
    with pytest.raises(ValueError, match="n_classes"):
        tfused.nw_prepared_cuda(torch.randn(2, 8, device=dev), prep, scale, "l2", 100_000)
    with pytest.raises(ValueError, match="bf16"):
        tfused.nw_prepared_cuda(torch.randn(2, 8, device=dev, dtype=torch.bfloat16), prep,
                                scale, "l2", 100_000)


# The tensor-core pass 1's plan (``_tc_query_tile``, ``_tc_splits``) at the
# H100's 132 SMs and shared memory: (name, rows, B, C, routing group, K6),
# the rows of K6 its slot-order rows (n_sel x block_s).
PLAN_CASES = [
    ("cub", 5994, 64, 200, None, False),
    ("cub_b256", 5994, 256, 200, None, False),
    ("eval_b8", 5800, 8, 200, None, False),
    ("shard", 250_000, 64, 1000, None, False),
    ("million", 1 << 20, 64, 1000, None, False),
    ("k6_skewed_union", 60 * 1024, 64, 1000, None, True),
    ("k6_full_probe", 1024 * 1024, 64, 1000, None, True),
    ("k6_diverse_g16", 16 * 4 * 1024, 64, 1000, 16, True),
    ("largest_c", 5994, 64, 3377, None, False),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_tensor_core_split_rule(case):
    """Every row lies in one split, every split holds whole 64-row tiles
    and none is empty, the blocks fill the SMs at most once (one block an
    SM), so the partials stay within one wave of blocks' ``acc[qb][C]``,
    and the query tile's block fits the card's shared memory."""
    _, n_rows, B, C, group, sel = case
    optin = tfused.H100_SMEM_OPTIN
    qb = tfused._tc_query_tile(group or B, C, sel, optin)
    assert qb in (8, 16, 32) and qb <= max(8, group or B)
    assert tfused._tc_smem_bytes(qb, C, sel) <= optin
    n_qtiles = (B // (group or B)) * -(-(group or B) // qb)
    rows, n_splits = tfused._tc_splits(n_rows, n_qtiles, 132)
    assert rows % 64 == 0 and rows >= 64
    assert n_splits * rows >= n_rows > (n_splits - 1) * rows
    assert n_splits <= max(1, -(-132 // n_qtiles))
    assert 4 * n_splits * B * C <= 4 * (132 + n_qtiles) * qb * C


def test_tensor_core_query_tile_follows_c():
    """32 queries a block at the CUB bank's C = 200 and at C = 1,000, 8 at
    the largest class count any prepared-bank kernel takes (3,377 on an
    H100), and the routing group or the batch caps it."""
    optin = tfused.H100_SMEM_OPTIN
    assert tfused._tc_query_tile(64, 200, False, optin) == 32
    assert tfused._tc_query_tile(64, 1000, False, optin) == 32
    assert tfused._tc_query_tile(16, 1000, True, optin) == 16
    assert tfused._tc_query_tile(5, 200, False, optin) == 8
    assert tfused._tc_query_tile(64, 3377, True, optin) == 8
    with pytest.raises(ValueError, match="n_classes"):
        tfused._tc_query_tile(64, 7000, False, optin)


@pytest.mark.gpu
def test_cuda_tensor_core_smem_matches_the_plan():
    """The kernel's shared-memory size is the one the wrapper plans with,
    and the card's opt-in limit is the H100's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    from nwhead_tpu_torch.ops import _cuda

    lib = _cuda.load_library()
    for qb in (8, 16, 32):
        for C in (1, 200, 1000, 3377):
            for sel in (0, 1):
                assert lib.nw_prepared_tc_smem_bytes(qb, C, sel) == \
                    tfused._tc_smem_bytes(qb, C, bool(sel))
    if "H100" in torch.cuda.get_device_name(0):
        assert tfused._smem_optin(lib, torch.device("cuda")) == tfused.H100_SMEM_OPTIN
