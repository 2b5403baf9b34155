"""The port's naive NW op and similarity kernels against the JAX package.

Same numpy inputs, from a seed, go through ``nwhead_tpu.ops`` and
``nwhead_tpu_torch.ops``. Both compute in f32 on the CPU and differ only in
summation order, hence rtol=atol=1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu.ops import kernels as jk
from nwhead_tpu.ops import nw as jnw
from nwhead_tpu_torch.ops import kernels as tk
from nwhead_tpu_torch.ops import nw as tnw

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KERNELS = tk.KERNEL_NAMES


def _params(kernel):
    """Both packages' kernel params, clip's scale moved off its init."""
    if kernel != "clip":
        return None, None
    return {"logit_scale": jnp.float32(1.3)}, {"logit_scale": torch.tensor(1.3)}


def test_kernel_registry_matches():
    assert tk.KERNEL_NAMES == jk.KERNEL_NAMES
    assert tk._NORMALIZE_EPS == jk._NORMALIZE_EPS == 1e-12
    assert tnw.LOG_FLOOR == jnw.LOG_FLOOR == 1e-12
    _, jinit = jk.get_kernel("clip")
    _, tinit = tk.get_kernel("clip")
    assert float(tinit["logit_scale"]) == pytest.approx(float(jinit["logit_scale"]), abs=1e-7)
    with pytest.raises(NotImplementedError):
        tk.get_kernel("relation")


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_scores_match(kernel):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    y = rng.standard_normal((2, 7, 16)).astype(np.float32)
    # An exact zero distance (integer entries, no rounding in the expanded
    # form): the clamped sqrt must give 0, not NaN.
    x[0, 2] = y[0, 3] = 2.0
    y[1, 4] = 0.0  # a zero row: the clamped norm keeps it finite
    jp, tp = _params(kernel)
    jfn, jinit = jk.get_kernel(kernel)
    tfn, tinit = tk.get_kernel(kernel)
    want = np.asarray(jfn(jp or jinit, jnp.asarray(x), jnp.asarray(y)))
    got = tfn(tp or tinit, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("support", ["shared", "per_query"])
@pytest.mark.parametrize("masked", [False, True])
def test_nw_log_probs_matches(kernel, support, masked):
    rng = np.random.default_rng(2)
    B, S, D, C = 4, 12, 16, 3
    q = rng.standard_normal((B, D)).astype(np.float32)
    shape = (S, D) if support == "shared" else (B, S, D)
    s = rng.standard_normal(shape).astype(np.float32)
    sy = rng.integers(0, C, size=shape[:-1]).astype(np.int64)
    mask = None
    if masked:
        mask = rng.random(shape[:-1]) > 0.3
        mask[..., 0] = True  # keep one valid row per query
    jp, tp = _params(kernel)
    want = np.asarray(jnw.nw_log_probs(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), C, kernel=kernel,
        kernel_params=jp, support_mask=None if mask is None else jnp.asarray(mask)))
    got = tnw.nw_log_probs(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy), C, kernel=kernel,
        kernel_params=tp, support_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (B, C)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_scores_and_weights_match(kernel):
    """nw_scores (masked to -inf), the softmax weights, multi-query input
    (B, Nq, D) and one-hot float labels."""
    rng = np.random.default_rng(3)
    B, Nq, S, D, C = 3, 2, 9, 8, 4
    q = rng.standard_normal((B, Nq, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=S)]
    mask = np.ones(S, bool)
    mask[[2, 5]] = False
    jp, tp = _params(kernel)
    js = np.asarray(jnw.nw_scores(jnp.asarray(q), jnp.asarray(s), kernel=kernel,
                                  kernel_params=jp, support_mask=jnp.asarray(mask)))
    ts = tnw.nw_scores(torch.from_numpy(q), torch.from_numpy(s), kernel=kernel,
                       kernel_params=tp, support_mask=torch.from_numpy(mask)).numpy()
    assert np.isneginf(ts[..., ~mask]).all()
    np.testing.assert_allclose(ts[..., mask], js[..., mask], **TOL)
    jpr, jw = jnw.nw_probs_and_weights(jnp.asarray(q), jnp.asarray(s), jnp.asarray(onehot), C,
                                       kernel=kernel, kernel_params=jp)
    tpr, tw = tnw.nw_probs_and_weights(torch.from_numpy(q), torch.from_numpy(s),
                                       torch.from_numpy(onehot), C, kernel=kernel,
                                       kernel_params=tp)
    assert tuple(tpr.shape) == (B, Nq, C) and tuple(tw.shape) == (B, Nq, S)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


@pytest.mark.parametrize("kernel,precision", [("euclidean", "f32"), ("clip", "bf16")])
def test_nw_head_forward_matches_jax_module(kernel, precision):
    """``NWHead.forward`` (the naive head; bf16 rounds the features first)
    vs the JAX ``NWHead`` on its naive path, with clip's scale carried over."""
    from nwhead_tpu.nw.head import NWHead as JaxNWHead
    from nwhead_tpu_torch.models.convert import jax_to_torch_head
    from nwhead_tpu_torch.nw.head import NWHead

    rng = np.random.default_rng(4)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    s = rng.standard_normal((10, 16)).astype(np.float32)
    sy = rng.integers(0, 3, size=10).astype(np.int32)
    jhead = JaxNWHead(n_classes=3, kernel_type=kernel, precision=precision, use_fused=False)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy))
    if kernel == "clip":
        params = {"params": {"logit_scale": jnp.float32(2.0)}}
    want = np.asarray(jhead.apply(params, jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy)))
    thead = NWHead(3, kernel, precision)
    thead.load_state_dict(jax_to_torch_head(params.get("params", {})))
    with torch.no_grad():
        got = thead(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_bins", [10, 15, 20])
def test_ece_bins_match_jax_on_the_edges(n_bins):
    """The port's ECE bin edges are ``jnp.linspace``'s: confidences placed
    exactly on every edge fall in the same bins, so the ECE is JAX's. With 15
    bins, probabilities [[0.6, 0.4], [0.58, 0.42]] and labels [0, 1] give
    0.0900 (``torch.linspace``'s edges gave 0.4900)."""
    from nwhead_tpu.ops import metrics as jmetrics
    from nwhead_tpu_torch.ops import metrics as tmetrics

    edges = np.asarray(jnp.linspace(0.0, 1.0, n_bins + 1))
    conf = np.concatenate([edges[1:], np.nextafter(edges[1:-1], 2.0, dtype=np.float32)])
    conf = np.clip(conf, 0.5, 1.0).astype(np.float32)  # the top class of two
    probs = np.stack([conf, 1.0 - conf], axis=1)
    labels = (np.arange(len(conf)) % 3 == 0).astype(np.int32)
    got = float(tmetrics.ece(torch.from_numpy(probs), torch.from_numpy(labels), n_bins))
    # Equal up to the f32 summation order; a confidence in another bin moves
    # the ECE by orders of magnitude more.
    assert got == pytest.approx(float(jmetrics.ece(jnp.asarray(probs), jnp.asarray(labels),
                                                   n_bins)), rel=1e-6, abs=1e-7)
    if n_bins == 15:
        probs = np.array([[0.6, 0.4], [0.58, 0.42]], np.float32)
        got = float(tmetrics.ece(torch.from_numpy(probs), torch.tensor([0, 1]), 15))
        assert got == pytest.approx(float(jmetrics.ece(jnp.asarray(probs),
                                                       jnp.asarray([0, 1]), 15)), abs=1e-7)
        assert got == pytest.approx(0.09, abs=1e-6)
