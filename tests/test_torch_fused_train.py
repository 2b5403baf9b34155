"""The port's fused raw-feature head (K1 forward, K3 backward) against the
JAX package.

The same numpy inputs go through the JAX function, its Pallas kernels in
interpret mode at ``block_s=128``, and through the port's plain PyTorch
versions (what a CPU tensor takes):

* K1 ``(out, m, l)``: the port's ``_nw_fwd_plain`` vs JAX ``_fwd_pallas``;
* K3 ``(dq, ds)``: ``_nw_bwd_plain`` vs JAX ``_bwd_pallas`` on the same
  ``u, r, m, l``;
* values and gradients of ``nw_fused_log_probs`` (autograd vs
  ``jax.grad``), all five kernels, clip's ``logit_scale`` gradient, masked
  rows, ragged B and S, f32 and bf16.

Tolerances: f32 forward rtol=atol=2e-4 (the bound the JAX kernel is held
to against its naive op), f32 gradients rtol=1e-3, atol=1e-5. bf16: both
round the same inputs to bf16 and differ in f32 summation order and in
rounding the normalization, so forward atol=5e-3 and gradients within 2e-2
of max|JAX gradient| (the gradients are bf16 values themselves).

The CUDA kernels are tested on the card only (marker ``gpu``). The GPU
machine has no jax, so this module imports the JAX package inside the
tests that compare with it; there the GPU tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_train.py``.
"""

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_nw as tfused
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=2e-4)
F32_GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ATOL = 5e-3
BF16_GRAD_REL = 2e-2
# (B, S, D, C): ragged B and S, D off every tile width; C > 128 once.
CASES = {"c7": (5, 300, 40, 7), "c150": (3, 260, 24, 150)}


def _inputs(case, seed=0):
    B, S, D, C = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    mask = (rng.random(S) > 0.1).astype(np.float32)
    g = rng.standard_normal((B, C)).astype(np.float32)
    return q, s, sy, mask, g, C


def _jax():
    """The JAX reference: ``(jax, jax.numpy, nwhead_tpu.ops.pallas_nw)``."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.ops import pallas_nw

    return jax, jnp, pallas_nw


def _labels(sy, mask):
    return torch.from_numpy(np.where(mask > 0, sy, -1).astype(np.int32))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_plain_forward_matches_jax_kernel(mode, case):
    """K1: ``(out, m, l)`` of the plain version vs JAX ``_fwd_pallas``."""
    jax, jnp, jfused = _jax()
    q, s, sy, mask, _, C = _inputs(case)
    scale = np.float32(1.7 if mode == "dot" else 1.0)
    out, m, l = jfused._fwd_pallas(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), jnp.asarray(mask), jnp.asarray(scale),
        mode=mode, n_classes=C, block_b=8, block_s=128, interpret=True)
    got = tfused._nw_fwd_plain(torch.from_numpy(q), torch.from_numpy(s), _labels(sy, mask),
                               torch.tensor([scale]), mode, C)
    B = q.shape[0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out), **F32)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(m)[:B], **F32)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(l)[:B], **F32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_plain_backward_matches_jax_kernel(mode, case):
    """K3: ``(dq, ds)`` of the plain version vs JAX ``_bwd_pallas`` on the
    same ``u, r, m, l`` (taken from the JAX forward)."""
    jax, jnp, jfused = _jax()
    q, s, sy, mask, g, C = _inputs(case, seed=1)
    scale = np.float32(1.7 if mode == "dot" else 1.0)
    args = (jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), jnp.asarray(mask),
            jnp.asarray(scale))
    kw = dict(mode=mode, n_classes=C, block_b=8, block_s=128, interpret=True)
    out, m, l = jfused._fwd_pallas(*args, **kw)
    u = jnp.asarray(g) * jnp.exp(-out)
    r = jnp.sum(u * (jnp.exp(out) - 1e-12), axis=-1, keepdims=True)
    dq, ds, _ = jfused._bwd_pallas(*args, u, r, m, l, **kw)
    B = q.shape[0]
    got_dq, got_ds = tfused._nw_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(s), _labels(sy, mask),
        torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(r)),
        torch.from_numpy(np.asarray(m)[:B]), torch.from_numpy(np.asarray(l)[:B]),
        torch.tensor([scale]), mode, C)
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(dq), **F32_GRAD)
    np.testing.assert_allclose(got_ds.numpy(), np.asarray(ds), **F32_GRAD)
    # The one-pass plain versions (the twins of the dq and ds kernels alone).
    args = (torch.from_numpy(q), torch.from_numpy(s), _labels(sy, mask),
            torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(r)),
            torch.from_numpy(np.asarray(m)[:B]), torch.from_numpy(np.asarray(l)[:B]),
            torch.tensor([scale]), mode, C)
    torch.testing.assert_close(tfused._nw_bwd_dq_plain(*args), got_dq, rtol=0, atol=0)
    torch.testing.assert_close(tfused._nw_bwd_ds_plain(*args), got_ds, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_plain_versions_keep_f64(mode):
    """Given f64 features the plain K1/K3 versions compute in f64 (the exact
    reference where a query coincides with a support row) and agree with
    the f32 evaluation."""
    q, s, sy, mask, g, C = _inputs("c7", seed=4)
    scale = torch.tensor([1.7 if mode == "dot" else 1.0])
    labels = _labels(sy, mask)
    outs = {}
    for dt in (torch.float32, torch.float64):
        qt, st = torch.from_numpy(q).to(dt), torch.from_numpy(s).to(dt)
        out, m, l = tfused._nw_fwd_plain(qt, st, labels, scale, mode, C)
        u = (torch.from_numpy(g) * torch.exp(-out.float())).contiguous()
        r = torch.sum(u * (torch.exp(out.float()) - 1e-12), dim=-1, keepdim=True)
        dq, ds = tfused._nw_bwd_plain(qt, st, labels, u, r, m.float(), l.float(), scale, mode, C)
        assert {x.dtype for x in (out, m, l, dq, ds)} == {dt}
        outs[dt] = [x.numpy() for x in (out, m, l, dq, ds)]
    for a, b in zip(outs[torch.float32][:3], outs[torch.float64][:3]):
        np.testing.assert_allclose(a, b, **F32)
    for a, b in zip(outs[torch.float32][3:], outs[torch.float64][3:]):
        np.testing.assert_allclose(a, b, **F32_GRAD)


def _port_value_and_grads(kernel, q, s, sy, mask, g, C, precision, logit_scale=1.3):
    qt = torch.from_numpy(q).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    ls = torch.tensor(logit_scale, requires_grad=True)
    params = {"logit_scale": ls} if kernel == "clip" else None
    out = tfused.nw_fused_log_probs(qt, st, torch.from_numpy(sy), C, kernel=kernel,
                                    kernel_params=params, support_mask=torch.from_numpy(mask),
                                    precision=precision)
    wrt = [qt, st] + ([ls] if kernel == "clip" else [])
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), wrt)
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_value_and_grads(kernel, q, s, sy, mask, g, C, precision, logit_scale=1.3):
    jax, jnp, jfused = _jax()

    def f(q_, s_, ls):
        params = {"logit_scale": ls} if kernel == "clip" else None
        return jfused.nw_fused_log_probs(
            q_, s_, jnp.asarray(sy), C, kernel=kernel, kernel_params=params,
            support_mask=jnp.asarray(mask), block_s=128, interpret=True, precision=precision)

    args = (jnp.asarray(q), jnp.asarray(s), jnp.float32(logit_scale))
    out = f(*args)
    argnums = (0, 1, 2) if kernel == "clip" else (0, 1)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(g)), argnums=argnums)(*args)
    return np.asarray(out), [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_fused_log_probs_and_grads_match_jax(kernel, case, precision):
    """``nw_fused_log_probs`` values and gradients in q, s (and clip's
    logit_scale) vs the JAX op through its custom VJP, masked rows."""
    q, s, sy, mask, g, C = _inputs(case, seed=2)
    got, got_g = _port_value_and_grads(kernel, q, s, sy, mask, g, C, precision)
    want, want_g = _jax_value_and_grads(kernel, q, s, sy, mask, g, C, precision)
    assert got.shape == (q.shape[0], C) and np.isfinite(got).all()
    if precision == "f32":
        np.testing.assert_allclose(got, want, **F32)
        for a, b in zip(got_g, want_g):
            np.testing.assert_allclose(a, b, **F32_GRAD)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        for a, b in zip(got_g, want_g):
            assert _rel(a, b) <= BF16_GRAD_REL


@pytest.mark.parametrize("kernel", ["euclidean", "clip"])
def test_masked_nan_rows_do_not_leak(kernel):
    """A masked row may hold NaN: values and gradients stay finite, masked
    rows get a zero gradient, and the rest equals JAX's on the same inputs
    with those rows zeroed. (JAX's gradient of a zeroed row is NaN under a
    normalizing kernel, from the norm's sqrt at 0, so masked rows of ds are
    left out of the comparison.)"""
    q, s, sy, mask, g, C = _inputs("c7", seed=3)
    zeroed = np.where(mask[:, None] > 0, s, 0).astype(np.float32)
    poisoned = np.where(mask[:, None] > 0, s, np.nan).astype(np.float32)
    got, got_g = _port_value_and_grads(kernel, q, poisoned, sy, mask, g, C, "f32")
    want, want_g = _jax_value_and_grads(kernel, q, zeroed, sy, mask, g, C, "f32")
    assert np.isfinite(got).all() and all(np.isfinite(x).all() for x in got_g)
    assert (got_g[1][mask == 0] == 0).all()
    np.testing.assert_allclose(got, want, **F32)
    got_g[1], want_g[1] = got_g[1][mask > 0], want_g[1][mask > 0]
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, **F32_GRAD)


def test_raw_path_contract():
    """The JAX function's errors: a PreparedSupport needs n_classes, takes
    no mask and keeps its own precision; the raw path takes 2-D features."""
    s = torch.randn(6, 3)
    sy = torch.tensor([0, 1, 0, 1, 0, 1])
    prep = tfused.prepare_support(s, sy, 2)
    q = torch.randn(2, 3)
    with pytest.raises(ValueError, match="n_classes"):
        tfused.nw_fused_log_probs(q, prep)
    with pytest.raises(ValueError, match="support_mask"):
        tfused.nw_fused_log_probs(q, prep, n_classes=2, support_mask=torch.ones(6))
    with pytest.raises(ValueError, match="precision"):
        tfused.nw_fused_log_probs(q, prep, n_classes=2, precision="bf16")
    np.testing.assert_allclose(tfused.nw_fused_log_probs(q, prep, n_classes=2).numpy(),
                               tfused.nw_fused_log_probs(q, s, sy, 2).detach().numpy(), **F32)
    with pytest.raises(ValueError, match="2-D"):
        tfused.nw_fused_log_probs(q[None], s, sy, 2)
    with pytest.raises(NotImplementedError):
        tfused.nw_fused_log_probs(q, s, sy, 2, kernel="relation")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The K1/K3 wrappers launch on CUDA tensors or raise; they never
    compute on the CPU."""
    q, s = torch.zeros(2, 3), torch.zeros(4, 3)
    labels, scale = torch.zeros(4, dtype=torch.int32), torch.ones(1)
    u, r, m, l = torch.zeros(2, 2), torch.zeros(2, 1), torch.zeros(2, 1), torch.ones(2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.nw_fwd_cuda(q, s, labels, scale, "l2", 2)
    for fn in (tfused.nw_bwd_dq_cuda, tfused.nw_bwd_ds_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, s, labels, u, r, m, l, scale, "l2", 2)


# -- on the card ------------------------------------------------------------------

GPU_SHAPES = [(8, 1200, 512, 200), (64, 5994, 512, 200), (37, 1001, 512, 200),
              (8, 1200, 512, 10), (1, 1, 3, 1), (17, 65, 33, 129), (300, 700, 100, 7)]


def _rel_t(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_cuda_kernels_match_plain(precision, shape):
    """On the card: K1 ``(out, m, l)``, K3 ``dq`` and ``ds`` vs the plain
    versions, all five kernels, masked rows holding NaN. Forward as K2
    (f32 rtol=atol=2e-4, bf16 atol 2e-3); gradients within 1e-3 (f32) or
    2e-2 (bf16) of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    fwd_tol = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}[precision]
    grad_rel = {"f32": 1e-3, "bf16": 2e-2}[precision]
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    B, S, D, C = shape
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    valid = rng.random(S) > 0.03
    valid[0] = True
    s[torch.from_numpy(~valid).to(dev)] = float("nan")
    labels = torch.from_numpy(np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
    for kernel in KERNEL_NAMES:
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        mode, scale, qn, sn = tfused._resolve_mode(kernel, params, q.to(dtype), s.to(dtype))
        qn, sn = qn.to(sn.dtype).contiguous(), sn.contiguous()
        before = (tfused.nw_fwd_cuda.launches, tfused.nw_bwd_dq_cuda.launches,
                  tfused.nw_bwd_ds_cuda.launches)
        out, m, l = tfused.nw_fwd_cuda(qn, sn, labels, scale, mode, C)
        want = tfused._nw_fwd_plain(qn, sn, labels, scale, mode, C)
        torch.testing.assert_close(out, want[0], **fwd_tol)
        torch.testing.assert_close(m, want[1], **fwd_tol)
        torch.testing.assert_close(l, want[2], rtol=2e-3 if precision == "bf16" else 2e-4,
                                   atol=1e-6)
        u = (g * torch.exp(-want[0])).contiguous()
        r = torch.sum(u * (torch.exp(want[0]) - 1e-12), dim=-1, keepdim=True)
        args = (qn, sn, labels, u, r, want[1], want[2], scale, mode, C)
        dq, ds = tfused.nw_bwd_dq_cuda(*args), tfused.nw_bwd_ds_cuda(*args)
        dq_p, ds_p = tfused._nw_bwd_plain(*args)
        torch.cuda.synchronize()
        after = (tfused.nw_fwd_cuda.launches, tfused.nw_bwd_dq_cuda.launches,
                 tfused.nw_bwd_ds_cuda.launches)
        assert after == tuple(x + 1 for x in before)
        assert dq.dtype == dtype and ds.dtype == dtype
        assert torch.isfinite(dq).all() and torch.isfinite(ds).all()
        assert (ds[torch.from_numpy(~valid).to(dev)] == 0).all()
        assert _rel_t(dq, dq_p) <= grad_rel, (kernel, _rel_t(dq, dq_p))
        assert _rel_t(ds, ds_p) <= grad_rel, (kernel, _rel_t(ds, ds_p))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_kernels_exact_on_duplicate_rows(precision):
    """On the card: six queries copied into the support (a query drawn into
    its own episode). The kernels sum |q|^2, |s|^2 and q.s in one order, so
    in l2 mode such a pair scores exactly 0; the f32 plain version leaves
    rounding residue there, so the reference is the plain version in f64.
    Tolerances as ``test_cuda_kernels_match_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    fwd_tol = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}[precision]
    grad_rel = {"f32": 1e-3, "bf16": 2e-2}[precision]
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    B, S, D, C = 8, 1200, 512, 200
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    rows = torch.from_numpy(rng.choice(S, 6, replace=False)).to(dev)
    labels = torch.from_numpy(rng.integers(0, C, size=S).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
    for kernel in KERNEL_NAMES:
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        mode, scale, qn, sn = tfused._resolve_mode(kernel, params, q.to(dtype), s.to(dtype))
        qn, sn = qn.to(sn.dtype).contiguous(), sn.clone().contiguous()
        sn[rows] = qn[:6]
        out, m, l = tfused.nw_fwd_cuda(qn, sn, labels, scale, mode, C)
        want = [x.float() for x in tfused._nw_fwd_plain(qn.double(), sn.double(), labels,
                                                          scale, mode, C)]
        torch.testing.assert_close(out, want[0], **fwd_tol)
        torch.testing.assert_close(m, want[1], **fwd_tol)
        if mode == "l2":
            assert (m[:6] == 0).all(), m[:6]
        u = (g * torch.exp(-want[0])).contiguous()
        r = torch.sum(u * (torch.exp(want[0]) - 1e-12), dim=-1, keepdim=True)
        args = (qn, sn, labels, u, r, want[1], want[2], scale, mode, C)
        dq, ds = tfused.nw_bwd_dq_cuda(*args), tfused.nw_bwd_ds_cuda(*args)
        dq_p, ds_p = tfused._nw_bwd_plain(qn.double(), sn.double(), *args[2:])
        assert _rel_t(dq, dq_p) <= grad_rel, (kernel, _rel_t(dq, dq_p))
        assert _rel_t(ds, ds_p) <= grad_rel, (kernel, _rel_t(ds, ds_p))


@pytest.mark.gpu
def test_cuda_autograd_matches_cpu():
    """On the card: autograd through ``nw_fused_log_probs`` (K1 + K3)
    equals the same call on CPU tensors (the plain versions), clip's
    scale gradient included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 512)).astype(np.float32)
    s = rng.standard_normal((1200, 512)).astype(np.float32)
    sy = rng.integers(0, 200, size=1200)
    g = rng.standard_normal((8, 200)).astype(np.float32)
    results = []
    for dev in ("cpu", "cuda"):
        qt = torch.tensor(q, device=dev, requires_grad=True)
        st = torch.tensor(s, device=dev, requires_grad=True)
        ls = torch.tensor(2.0, device=dev, requires_grad=True)
        out = tfused.nw_fused_log_probs(qt, st, torch.tensor(sy, device=dev), 200,
                                        kernel="clip", kernel_params={"logit_scale": ls})
        grads = torch.autograd.grad(torch.sum(out * torch.tensor(g, device=dev)), [qt, st, ls])
        results.append([out.detach().cpu()] + [x.cpu() for x in grads])
    cpu, gpu = results
    torch.testing.assert_close(gpu[0], cpu[0], rtol=2e-4, atol=2e-4)
    for a, b in zip(gpu[1:], cpu[1:]):
        assert _rel_t(a, b) <= 1e-3
