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


GPU_SHAPES = [(64, 5994, 512, 200), (8, 5800, 512, 200), (64, 5800, 384, 200),
              (37, 1001, 509, 150), (1, 1, 3, 1), (17, 65, 33, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_cuda_quant_kernel_matches_plain(precision, shape):
    """On the card: K4/K5 vs the plain version, all five kernels, masked rows
    holding NaN, at the CUB-200 shape, the training eval's B=8, the ViT-S/14
    bank's D=384, and ragged ones (D off the word and the chunk, one row,
    one class); rtol=atol=2e-4."""
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
        want = tfused._nw_prepared_plain(q8, prep, scale, mode, C, qscale)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(tfused.nw_fused_from_prepared(q, prep, C, kernel=kernel,
                                                                 kernel_params=params), got)


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
