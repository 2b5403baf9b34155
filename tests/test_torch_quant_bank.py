"""The port's int8 and int4 prepared banks (K4, K5) and the raw path at
those precisions, against the JAX package.

``prepare_support(precision='int8'|'int4')`` must give JAX's codes, row
scales and self-norms (the int4 codes unpacked): exactly where both
compute them from the same inputs; within one f32 rounding (rtol 1e-6)
where the two sum in other orders (int8 self-norms) or normalize one ulp
apart (the normalized kernels' scales). The plain K4/K5 head must match
JAX's ``nw_fused_from_prepared``, whose Pallas kernel runs here in
interpret mode, within rtol=atol=2e-4 for all five similarity kernels. On
raw features ``int8``/``int4`` run at f32, as the JAX raw path does. The
CUDA kernels are tested on the card only (marker ``gpu``), with
``python -m pytest --noconftest -m gpu tests/test_torch_quant_bank.py``.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
# (B, S, D, C): C <= 128 keeps input order; C > 128 sorts rows by class; D=37
# pads the int8 bank to 40 and the int4 bank to 40 (20 bytes a row).
CASES = {"c7": (5, 300, 40, 7), "c150": (5, 400, 24, 150), "d37": (4, 200, 37, 9)}
PRECISIONS = ("int8", "int4")


def _inputs(case, seed=0, nan=True):
    B, S, D, C = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    mask = (rng.random(S) > 0.1).astype(np.float32)
    if nan:
        s[mask == 0] = np.nan  # masked rows may hold anything
    return q, s, sy, mask, C


def _jax():
    import jax.numpy as jnp

    from nwhead_tpu.ops import pallas_nw

    return jnp, pallas_nw


def _params(kernel):
    if kernel != "clip":
        return None, None
    jnp, _ = _jax()
    return {"logit_scale": jnp.float32(1.3)}, {"logit_scale": torch.tensor(1.3)}


def _jax_codes(jp, precision, S, D):
    """JAX's bank codes ``(S, D)`` (the int4 bytes unpacked)."""
    b = np.asarray(jp.s)
    if precision == "int8":
        return b.astype(np.int32)[:S, :D]
    b = b.view(np.int8).astype(np.int32)
    return np.concatenate([(b & 15) - 8, b >> 4], axis=1)[:S, :D]


def _prepare_both(s, sy, mask, C, kernel, precision):
    jnp, jfused = _jax()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # int4 + dotproduct warns
        jp, jorder = jfused.prepare_support(
            jnp.asarray(s), jnp.asarray(sy), C, kernel=kernel, support_mask=jnp.asarray(mask),
            precision=precision, return_order=True)
        tp, torder = tfused.prepare_support(
            torch.from_numpy(s), torch.from_numpy(sy), C, kernel=kernel,
            support_mask=torch.from_numpy(mask), precision=precision, return_order=True)
    return jp, jorder, tp, torder


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", ["euclidean", "cosine"])
def test_quantized_bank_matches_jax(kernel, case, precision):
    """Codes, row scales, self-norms, labels and row order, masked rows
    holding NaN; C > 128 in class-sorted order."""
    q, s, sy, mask, C = _inputs(case)
    S, D = s.shape
    jp, jorder, tp, torder = _prepare_both(s, sy, mask, C, kernel, precision)
    if C > 128:
        assert torder is not None and np.array_equal(torder, jorder)
    else:
        assert torder is None and jorder is None
    order = np.arange(S) if torder is None else torder
    valid = mask[order] > 0
    assert tp.s.dtype == {"int8": torch.int8, "int4": torch.uint8}[precision]
    codes = tfused.bank_codes(tp).numpy().astype(np.int32)
    np.testing.assert_array_equal(codes[:, :D], _jax_codes(jp, precision, S, D))
    assert (codes[:, D:] == 0).all() and (codes[~valid] == 0).all()
    np.testing.assert_array_equal(tp.labels.numpy(), np.asarray(jp.lane).reshape(-1)[:S])
    jscale = np.asarray(jp.sscale).reshape(-1)[:S]
    if kernel == "euclidean":  # the same inputs: the same scales, bit for bit
        np.testing.assert_array_equal(tp.sscale.numpy(), jscale)
        js2 = np.asarray(jp.s2c).reshape(-1)[:S]
        if precision == "int4":  # sum of integer squares: exact in both
            np.testing.assert_array_equal(tp.s2.numpy(), js2)
        else:  # f32 sums of squares, in two summation orders
            np.testing.assert_allclose(tp.s2.numpy(), js2, rtol=1e-6)
        assert (tp.s2.numpy()[~valid] == 1e30).all()
    else:  # the normalized rows may round one ulp apart
        np.testing.assert_allclose(tp.sscale.numpy(), jscale, rtol=1e-6)
        assert tp.s2 is None and jp.s2c is None


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["c7", "c150", "d37"])
@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_plain_quant_head_matches_jax(kernel, case, precision):
    """Plain K4/K5 (``nw_fused_from_prepared`` on the CPU) vs JAX's Pallas
    kernel in interpret mode, ragged B, masked rows holding NaN."""
    jnp, jfused = _jax()
    q, s, sy, mask, C = _inputs(case, seed=2)
    jparams, tparams = _params(kernel)
    jp, _, tp, _ = _prepare_both(s, sy, mask, C, kernel, precision)
    want = np.asarray(jfused.nw_fused_from_prepared(jnp.asarray(q), jp, C, kernel=kernel,
                                                    kernel_params=jparams))
    got = tfused.nw_fused_from_prepared(torch.from_numpy(q), tp, C, kernel=kernel,
                                        kernel_params=tparams).numpy()
    assert got.shape == (q.shape[0], C) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    # Through nw_fused_log_probs too, whose precision check reads the bank's.
    again = tfused.nw_fused_log_probs(torch.from_numpy(q), tp, None, C, kernel=kernel,
                                      kernel_params=tparams, precision=precision).numpy()
    np.testing.assert_array_equal(again, got)


def test_query_quantization_matches_jax():
    """The query's int8 codes and scales: JAX's per-query ``amax/127``
    and ``round(q / scale)``, a division, for an int8 and an int4 bank."""
    q, s, sy, mask, C = _inputs("d37", seed=3)
    for precision in PRECISIONS:
        tp = tfused.prepare_support(torch.from_numpy(s), torch.from_numpy(sy), C,
                                    support_mask=torch.from_numpy(mask), precision=precision)
        q8, _, _, qscale = tfused._prepared_query(torch.from_numpy(q), tp)
        amax = np.abs(q).max(1)
        want_scale = np.where(amax > 0, amax / np.float32(127.0), 1.0).astype(np.float32)
        np.testing.assert_array_equal(qscale.numpy(), want_scale)
        want = np.clip(np.round(q / want_scale[:, None]), -127, 127)
        assert q8.shape == (q.shape[0], tfused._bank_width(tp))
        np.testing.assert_array_equal(q8.numpy()[:, :q.shape[1]], want)
        assert (q8.numpy()[:, q.shape[1]:] == 0).all()


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kernel", ["euclidean", "cosine", "clip"])
def test_raw_path_runs_f32(kernel, precision):
    """``nw_fused_log_probs`` on raw features at int8/int4 equals JAX's
    (f32, Pallas K1 in interpret mode) and the port's own f32 result."""
    jnp, jfused = _jax()
    q, s, sy, mask, C = _inputs("c7", seed=4, nan=False)
    jparams, tparams = _params(kernel)
    want = np.asarray(jfused.nw_fused_log_probs(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), C, kernel=kernel,
        kernel_params=jparams, support_mask=jnp.asarray(mask), precision=precision))
    args = (torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy), C)
    kw = dict(kernel=kernel, kernel_params=tparams, support_mask=torch.from_numpy(mask))
    got = tfused.nw_fused_log_probs(*args, precision=precision, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, tfused.nw_fused_log_probs(*args, **kw).numpy())


def test_nwhead_int8_trains_like_jax():
    """An int8 ``NWHead`` on an episode above ``fused_min_support`` takes the
    fused raw path at f32 in both packages: same log-probs, same loss
    gradient in the query and support features."""
    import jax

    from nwhead_tpu.nw.head import NWHead as JaxNWHead
    from nwhead_tpu_torch.nw.head import NWHead

    jnp, _ = _jax()
    q, s, sy, _, C = _inputs("c7", seed=5, nan=False)
    y = np.arange(q.shape[0]) % C
    head = JaxNWHead(C, precision="int8", fused_min_support=64)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy))

    def loss(qf, sf):
        lp = head.apply(params, qf, sf, jnp.asarray(sy))
        return -jnp.mean(lp[jnp.arange(len(y)), jnp.asarray(y)]), lp

    (jl, jlp), (jgq, jgs) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q), jnp.asarray(s))
    thead = NWHead(C, precision="int8", fused_min_support=64)
    tq = torch.from_numpy(q).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    assert thead.takes_fused(tq, ts)
    tlp = thead(tq, ts, torch.from_numpy(sy))
    tl = -tlp[torch.arange(len(y)), torch.from_numpy(y)].mean()
    tl.backward()
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in ((tq.grad, jgq), (ts.grad, jgs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_int4_dotproduct_warns():
    s = torch.randn(8, 16)
    with pytest.warns(UserWarning, match="int4"):
        tfused.prepare_support(s, np.arange(8) % 2, 2, kernel="dotproduct", precision="int4")


def test_quant_wrappers_refuse_cpu_tensors():
    """The K4/K5 wrappers launch on CUDA tensors or raise; they never
    compute on the CPU."""
    s = torch.randn(70, 8)
    for precision, wrapper in (("int8", tfused.nw_prepared_int8_cuda),
                               ("int4", tfused.nw_prepared_int4_cuda)):
        prep = tfused.prepare_support(s, np.arange(70) % 5, 5, precision=precision)
        q8, scale, mode, qscale = tfused._prepared_query(torch.randn(2, 8), prep)
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q8, prep, scale, mode, 5, qscale)


def _int4_dots_in_kernel_order(q_k: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The int4 kernel's integer dot products, in its layout: the query in
    its k order (``_int4_query``) against the packed bank's bytes, run by
    run, the low nibbles (minus 8) with the run's first 16 query bytes and
    the high nibbles (sign-extended) with its last 16; bytes past the row
    read as 0, as the kernel stages them. int64 ``(B, S)``."""
    S, half = packed.shape
    b = torch.nn.functional.pad(packed.to(torch.int64), (0, -(-half // 16) * 16 - half))
    runs = b.reshape(S, -1, 16)
    low, hi = (runs & 0xF) - 8, (runs >> 4) & 0xF
    hi = hi - ((hi & 8) << 1)
    codes = torch.cat([low, hi], dim=2).reshape(S, -1)  # the bank in the kernel's k order
    return q_k.to(torch.int64) @ codes.T


@pytest.mark.parametrize("width", [8, 40, 392, 512])
def test_int4_query_order_gives_the_exact_products(width):
    """The int4 kernel's k order (``_int4_query``: per run of 16 packed
    bytes, their low features, then their high ones) against the packed
    bank's nibbles in that layout gives q8 . codes exactly, for ragged
    D_pad too (a last run shorter than 16 bytes, padded with zeros); and
    one permutation of both operands leaves the integer sums as they are."""
    rng = np.random.default_rng(width)
    q8 = torch.from_numpy(rng.integers(-127, 128, (6, width)).astype(np.int8))
    codes = torch.from_numpy(rng.integers(-7, 8, (50, width)).astype(np.int8))
    packed = tfused._int4_pack(codes)
    assert torch.equal(tfused.unpack_int4(packed), codes)
    want = q8.to(torch.int64) @ codes.to(torch.int64).T
    q_k = tfused._int4_query(q8)
    assert q_k.shape == (6, -(-width // 32) * 32) and q_k.dtype == torch.int8
    assert torch.equal(_int4_dots_in_kernel_order(q_k, packed), want)
    perm = torch.from_numpy(rng.permutation(width))
    assert torch.equal(q8[:, perm].to(torch.int64) @ codes[:, perm].to(torch.int64).T, want)


@pytest.mark.parametrize("D", [37, 512, 2048])
def test_plain_quant_dots_are_the_int32_sums(D):
    """The plain K4/K5 dot products are the exact integer sums, and their
    f32 is the integer rounded to nearest (``__int2float_rn``), also past
    2^24 (D = 2,048 at full codes): the bits the kernel must reproduce."""
    rng = np.random.default_rng(D)
    q8 = rng.integers(-127, 128, (5, D)).astype(np.int8)
    codes = rng.integers(-127, 128, (40, D)).astype(np.int8)
    codes[0] = np.where(q8[0] >= 0, 127, -127)  # |dot| up to 127^2 D
    q8[0] = np.where(q8[0] >= 0, 127, -127)
    exact = q8.astype(np.int64) @ codes.astype(np.int64).T
    got = tfused._quant_dots_plain(torch.from_numpy(q8), torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), exact.astype(np.float64))
    assert np.array_equal(got.to(torch.float32).numpy(), exact.astype(np.float32))
    assert D < 2048 or abs(exact[0, 0]) > 1 << 24


class _FakeLibrary:
    """Records the K4/K5/K6 entry points' arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def nw_prepared_quant_forward(self, *args):
        self.calls.append(("quant", args))
        return 0

    def nw_prepared_sel_forward(self, *args):
        self.calls.append(("sel", args))
        return 0

    def nw_prepared_support_tile(self):
        return 64


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quant_launch_takes_the_tensor_core_plan(precision, monkeypatch):
    """The K4/K5 and K6 int8/int4 wrappers plan as the float banks do: on
    the million-row bank (2^20 rows, C = 1,000, B = 64, an H100's 132 SMs)
    32 queries a block and 66 splits; K6 on the skewed batch's union (60
    tiles of 1,024) 32 queries and ``_tc_splits``' count; an int4 bank gets
    the query in its k order (D_pad rounded up to 32 columns)."""
    lib = _FakeLibrary()

    def check(name, q, prep, scale, mode, n_classes, qscale, *rest):
        return lib, qscale

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(tfused, "_check_prepared", check)
    monkeypatch.setattr(tfused, "_smem_optin", lambda lib, device: tfused.H100_SMEM_OPTIN)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    seen = []
    real = tfused._int4_query
    monkeypatch.setattr(tfused, "_int4_query", lambda q: seen.append(real(q)) or seen[-1])
    S, D, C, B = 1 << 20, 512, 1000, 64
    dtype = torch.int8 if precision == "int8" else torch.uint8
    width = D if precision == "int8" else D // 2
    prep = tfused.PreparedSupport(
        s=torch.empty((S, width), dtype=dtype), s2=torch.empty(S), labels=torch.empty(
            S, dtype=torch.int32), sscale=torch.empty(S), block_s=1024)
    q8 = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (B, D)).astype(np.int8))
    wrapper = {"int8": tfused.nw_prepared_int8_cuda, "int4": tfused.nw_prepared_int4_cuda}[
        precision]
    wrapper(q8, prep, torch.ones(1), "l2", C, torch.ones(B))
    kind, args = lib.calls[-1]
    assert kind == "quant"
    (B_, S_, D_, C_, l2, int4, n_splits, rows, qb, partials) = args[12:22]
    assert (B_, S_, D_, C_, l2, int4, partials) == (B, S, D, C, 1, int(precision == "int4"), 0)
    assert (qb, n_splits) == (32, 66) and n_splits * rows >= S > (n_splits - 1) * rows
    if precision == "int4":
        assert args[0] == seen[-1].data_ptr() and torch.equal(seen[-1], real(q8))
    tile_sel = torch.cat([torch.arange(60, dtype=torch.int32), torch.full((4,), -1,
                                                                          dtype=torch.int32)])
    tfused.nw_prepared_sel_quant_cuda(q8, prep, torch.ones(1), "l2", C, torch.ones(B), tile_sel)
    kind, args = lib.calls[-1]
    assert kind == "sel"
    (B_, D_, C_, l2, bank, n_sel, per_row, n_tiles, block_s, n_splits, qt, partials) = \
        args[14:26]
    assert (B_, D_, bank, n_sel, n_tiles, block_s, qt) == (
        B, D, 2 if precision == "int8" else 3, 64, 1024, 1024, 32)
    assert n_splits == tfused._tc_splits(64 * 1024, 2, 132)[1]


GPU_SHAPES = [(64, 5994, 512, 200), (8, 5800, 512, 200), (64, 5800, 384, 200),
              (37, 1001, 509, 150), (1, 1, 3, 1), (17, 65, 33, 129),
              # C = 1,000, class-sorted: query tiles of 8, 16, 32 and 32
              (8, 20_000, 512, 1000), (16, 20_000, 512, 1000), (32, 20_000, 512, 1000),
              (64, 20_000, 512, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_cuda_quant_kernel_matches_plain(precision, shape):
    """On the card: K4/K5 vs the plain version, all five kernels, masked rows
    holding NaN, at the CUB-200 shape, the training eval's B=8, the ViT-S/14
    bank's D=384, ragged ones (D off the word and the chunk, one row, one
    class) and C = 1,000 at B = 8, 16, 32 and 64 (each query tile);
    rtol=atol=2e-4. Two calls give the same bits; at C > 128 the
    ``partials=True`` route holds its plain version too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    B, S, D, C = shape
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    sy = rng.integers(0, C, size=S)
    mask = torch.from_numpy((rng.random(S) > 0.03).astype(np.float32))
    mask[0] = 1.0
    s[(mask == 0).to(dev)] = float("nan")
    wrapper = {"int8": tfused.nw_prepared_int8_cuda, "int4": tfused.nw_prepared_int4_cuda}[
        precision]
    for kernel in KERNEL_NAMES:
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prep = tfused.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                          precision=precision)
        q8, scale, mode, qscale = tfused._prepared_query(q, prep, kernel, params)
        before = wrapper.launches
        got = wrapper(q8, prep, scale, mode, C, qscale)
        again = wrapper(q8, prep, scale, mode, C, qscale)
        want = tfused._nw_prepared_plain(q8, prep, scale, mode, C, qscale)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)
        torch.testing.assert_close(tfused.nw_fused_from_prepared(q, prep, C, kernel=kernel,
                                                                 kernel_params=params), got)
        if C > 128:
            partials = {"int8": tfused.nw_prepared_partials_int8_cuda,
                        "int4": tfused.nw_prepared_partials_int4_cuda}[precision]
            for g, w in zip(partials(q8, prep, scale, mode, C, qscale),
                            tfused._nw_prepared_plain(q8, prep, scale, mode, C, qscale,
                                                      partials=True)):
                torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
def test_cuda_quant_kernel_refuses_what_it_does_not_take():
    """A float query for a quantized bank, or a missing query scale, raises;
    nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    dev = torch.device("cuda")
    prep = tfused.prepare_support(torch.randn(70, 8, device=dev), np.arange(70) % 5, 5,
                                  precision="int8")
    q8, scale, mode, qscale = tfused._prepared_query(torch.randn(2, 8, device=dev), prep)
    with pytest.raises(ValueError, match="query"):
        tfused.nw_prepared_int8_cuda(q8.float(), prep, scale, mode, 5, qscale)
    with pytest.raises(ValueError, match="qscale"):
        tfused.nw_prepared_int8_cuda(q8, prep, scale, mode, 5, None)
    with pytest.raises(ValueError, match="bank"):
        tfused.nw_prepared_int4_cuda(q8, prep, scale, mode, 5, qscale)
