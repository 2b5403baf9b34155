"""Explainability and calibration of the port against the JAX package.

* ``ops.influence.support_influence`` equals JAX's on the same probabilities
  and weights (rtol 1e-5), for int and one-hot query labels and (S,),
  (B, S), (S, C) and (B, S, C) support labels; JAX's own checks
  (tests/test_metrics.py: the reference's per-item loop, the signs) hold.
* ``NWHead.probs_and_weights`` and ``scores`` equal the JAX head's for all
  five kernels with a support mask (rtol 1e-5).
* ``NWNet.get_neighbors`` gives JAX's order exactly on integer-valued
  features full of tied scores (the larger index first among ties), and
  ``NWNet.support_influence(mode="full")`` JAX's on converted weights and
  the JAX bank's features; ``ensemble`` raises.
* ``apply_temperature`` at T=1 is a no-op and JAX's at any T;
  ``fit_temperature`` gives JAX's T within 1e-4 relative on the same
  log-probs (JAX's tests/test_calibrate.py cases), or, where the f32 NLL is
  flat within its rounding, a minimizer at least as good (see the test).
* ``RelationNetwork`` on converted weights equals JAX's in eval and train
  BatchNorm within 1e-5, running statistics included.
* The new modules import neither jax nor scikit-learn.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu.ops import calibrate as jcal
from nwhead_tpu.ops.influence import support_influence as jax_influence
from nwhead_tpu.ops.nw import nw_probs_and_weights as jax_probs_and_weights
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel, jax_to_torch_relation
from nwhead_tpu_torch.nw.head import NWHead
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import calibrate as tcal
from nwhead_tpu_torch.ops.influence import support_influence
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES, RelationNetwork
from nwhead_tpu_torch.ops.metrics import ece, nll_loss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, D, C = 3, 10, 8, 4


def _probs_weights(rng):
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    qy = rng.integers(0, C, size=B).astype(np.int32)
    probs, weights = jax_probs_and_weights(jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), C)
    return np.asarray(probs), np.asarray(weights), qy, sy


@pytest.mark.parametrize("qform", ["int", "onehot"])
@pytest.mark.parametrize("sform", ["S", "BS", "SC", "BSC"])
def test_support_influence_matches_jax(qform, sform):
    probs, weights, qy, sy = _probs_weights(np.random.default_rng(0))
    eye = np.eye(C, dtype=np.float32)
    q = qy if qform == "int" else eye[qy]
    s = {"S": sy, "BS": np.tile(sy, (B, 1)), "SC": eye[sy], "BSC": np.tile(eye[sy], (B, 1, 1))}[
        sform]
    want = np.asarray(jax_influence(jnp.asarray(probs), jnp.asarray(q), jnp.asarray(weights),
                                    jnp.asarray(s)))
    got = support_influence(torch.from_numpy(probs), torch.from_numpy(q),
                            torch.from_numpy(weights), torch.from_numpy(s))
    assert got.shape == (B, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_support_influence_matches_the_reference_loop():
    """The reference's per-item loop (util/metric.py:35-49), JAX's own check."""
    probs, weights, qy, sy = _probs_weights(np.random.default_rng(1))
    got = support_influence(torch.from_numpy(probs), torch.from_numpy(qy),
                            torch.from_numpy(weights), torch.from_numpy(sy)).numpy()
    for b in range(B):
        p = probs[b, qy[b]]
        ind = (sy == qy[b]).astype(np.float32)
        want = np.log((p - p * weights[b]) / (p - weights[b] * ind))
        np.testing.assert_allclose(got[b], want, rtol=1e-3, atol=2e-4)


def test_influence_signs():
    head = NWHead(3)
    q = torch.zeros((1, 4))
    s = torch.stack([torch.zeros(4), torch.ones(4) * 3])
    sy = torch.tensor([0, 1])
    probs, weights = head.probs_and_weights(q, s, sy)
    infl = support_influence(probs, torch.tensor([0]), weights, sy)
    assert infl[0, 0] > 0 and infl[0, 1] < 0


def _heads(kernel):
    from nwhead_tpu.nw.head import NWHead as JaxNWHead

    jhead = JaxNWHead(C, kernel)
    variables = {"params": {"logit_scale": jnp.float32(2.0)}} if kernel == "clip" else {}
    thead = NWHead(C, kernel)
    if kernel == "clip":
        with torch.no_grad():
            thead.logit_scale.fill_(2.0)
    return jhead, variables, thead


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_head_probs_weights_and_scores_match_jax(kernel):
    from nwhead_tpu.nw.head import NWHead as JaxNWHead

    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    mask = (np.arange(S) % 4 != 1).astype(np.float32)
    jhead, variables, thead = _heads(kernel)
    jargs = (jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), jnp.asarray(mask))
    jp, jw = jhead.apply(variables, *jargs, method=JaxNWHead.probs_and_weights)
    jsc = jhead.apply(variables, jargs[0], jargs[1], jargs[3], method=JaxNWHead.scores)
    with torch.no_grad():
        tp, tw = thead.probs_and_weights(torch.from_numpy(q), torch.from_numpy(s),
                                         torch.from_numpy(sy), torch.from_numpy(mask))
        tsc = thead.scores(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(mask))
    assert tp.shape == (B, C) and tw.shape == (B, S) and tsc.shape == (B, 1, S)
    assert bool((tw[:, mask == 0] == 0).all()) and bool(torch.isinf(tsc[..., mask == 0]).all())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=1e-6)


def _jax_net(dataset, **kw):
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JaxNWNet

    jnet = JaxNWNet(jload("resnet10"), 4, support_dataset=dataset, **kw)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(dataset.gather(np.arange(8))))
    return jnet, jax.tree_util.tree_map(np.asarray, variables)


def _port_net(variables, **kw):
    train = tdata.make_synthetic_dataset(n=48, n_classes=4, size=32, seed=0)
    net = NWNet(load_model("resnet10", device="cpu"), 4, support_dataset=train, device="cpu",
                **kw)
    net.model.load_state_dict(jax_to_torch_nwmodel(variables))
    return net


def test_get_neighbors_matches_jax_with_ties():
    """Features of small integers: every squared distance is exact, so the
    bank is full of exactly tied scores; both packages rank them by a
    stable ascending sort reversed (the larger index first). The
    featurizer is the identity on both sides: the images are features."""
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn

    jnet, variables = _jax_net(jsyn(n=48, n_classes=4, size=32, seed=0), n_shot_full=12)
    tnet = _port_net(variables, n_shot_full=12)
    rng = np.random.default_rng(3)
    feat = rng.integers(-1, 2, size=(48, 6)).astype(np.float32)
    sy = np.arange(48) % 4
    meta = np.zeros(48, np.int64)
    jnet.support_eval.build_infer_iters(feat, sy, meta, [feat], [sy], [meta])
    jnet.full_feat = jnet.support_eval.full_feat
    tnet.support_eval.build_infer_iters(torch.from_numpy(feat), sy)
    jnet._featurize_eval = lambda v, x: x
    tnet._featurize_eval = lambda x: x
    q = rng.integers(-1, 2, size=(5, 6)).astype(np.float32)
    want = jnet.get_neighbors(variables, jnp.asarray(q))
    got = tnet.get_neighbors(q)
    assert got.shape == (5, 48)
    dist = ((q[:, None, :] - feat[None]) ** 2).sum(-1)
    assert all(len(np.unique(row)) <= 24 for row in dist)  # 48 rows, at most 24 scores
    np.testing.assert_array_equal(got, want)


def test_support_influence_of_the_net_matches_jax():
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn

    train, val = jsyn(n=48, n_classes=4, size=32, seed=0), jsyn(n=16, n_classes=4, size=32,
                                                                seed=1)
    jnet, variables = _jax_net(train, n_shot_full=8)
    jnet.precompute(variables)
    tnet = _port_net(variables, n_shot_full=8)
    tnet.support_eval.build_infer_iters(torch.from_numpy(np.asarray(jnet.full_feat)),
                                        np.asarray(jnet.full_y))
    tnet._build_serving_banks()
    x, y = val.gather(np.arange(6)), val.targets[:6]
    want = jnet.support_influence(variables, jnp.asarray(x), y, mode="full")
    got = tnet.support_influence(x, y, mode="full")
    assert got.shape == (6, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="per-support-set"):
        tnet.support_influence(x, y, mode="ensemble")


def _overconfident(B_=4096, C_=20, t_true=2.5, seed=0):
    """JAX's tests/test_calibrate.py model: labels from softmax(z), the
    model reporting softmax(z * t_true)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B_, C_)).astype(np.float32) * 2.0
    p = np.asarray(jax.nn.softmax(jnp.asarray(z), axis=-1))
    labels = np.array([rng.choice(C_, p=row / row.sum()) for row in p])
    return np.asarray(jax.nn.log_softmax(jnp.asarray(z) * t_true)), labels


def test_apply_temperature_one_is_a_noop():
    lp = torch.log_softmax(torch.from_numpy(
        np.random.default_rng(1).standard_normal((8, 10)).astype(np.float32)), -1)
    np.testing.assert_allclose(tcal.apply_temperature(lp, 1.0).numpy(), lp.numpy(), atol=1e-6)


def _nll64(lp: np.ndarray, y: np.ndarray, T: float) -> float:
    z = lp.astype(np.float64) / T
    z = z - z.max(1, keepdims=True)
    z = z - np.log(np.exp(z).sum(1, keepdims=True))
    return float(-z[np.arange(len(y)), y].mean())


@pytest.mark.parametrize("case", [dict(), dict(B_=2048, C_=12, t_true=1.8, seed=3),
                                  dict(C_=10, t_true=1.0, seed=7), dict(B_=40, C_=200, seed=5)])
def test_fit_temperature_matches_jax(case):
    """T within 1e-4 relative of JAX's, or, where the f32 NLL is flat within
    its rounding around the minimum (JAX's first two cases), a minimizer at
    least as good as JAX's: its NLL in f64 at most one f32 ulp above that
    of JAX's T, T within 1e-3. XLA's exp, log and sums round otherwise than
    torch's, so the two searches part where their f32 NLLs are noise."""
    lp, y = _overconfident(**case)
    want = float(jcal.fit_temperature(jnp.asarray(lp), jnp.asarray(y)))
    got = tcal.fit_temperature(torch.from_numpy(lp), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    rel = abs(float(got) - want) / want
    gap = _nll64(lp, y, float(got)) - _nll64(lp, y, want)
    ulp = float(np.spacing(np.float32(_nll64(lp, y, want))))
    assert rel <= 1e-3 and (rel <= 1e-4 or gap <= ulp), (float(got), want, gap, ulp)
    cal = tcal.apply_temperature(torch.from_numpy(lp), want)
    np.testing.assert_allclose(cal.numpy(), np.asarray(jcal.apply_temperature(
        jnp.asarray(lp), want)), rtol=1e-5, atol=1e-6)


def test_fit_recovers_a_known_temperature():
    lp, y = _overconfident()
    lp_t, y_t = torch.from_numpy(lp), torch.from_numpy(y)
    T = float(tcal.fit_temperature(lp_t, y_t))
    assert 2.0 < T < 3.0
    cal = tcal.apply_temperature(lp_t, T)
    assert float(nll_loss(cal, y_t)) < float(nll_loss(lp_t, y_t)) - 1e-3
    assert float(ece(torch.exp(cal), y_t)) < float(ece(torch.exp(lp_t), y_t))


@pytest.mark.parametrize("train", [False, True])
def test_relation_network_matches_jax(train):
    from nwhead_tpu.ops.kernels import RelationNetwork as JaxRelationNetwork

    rng = np.random.default_rng(4)
    bs, nq, ns, h, c = 2, 3, 4, 8, 5
    x = rng.standard_normal((bs, nq, h, h, c)).astype(np.float32)
    y = rng.standard_normal((bs, ns, h, h, c)).astype(np.float32)
    jrn = JaxRelationNetwork(c, 64 * (h // 4) ** 2, 16)
    variables = jax.tree_util.tree_map(np.asarray, jrn.init(jax.random.PRNGKey(1),
                                                            jnp.asarray(x), jnp.asarray(y)))
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.standard_normal(v.shape) * 0.1 if path[-1].key == "mean"
                         else rng.random(v.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    trn = RelationNetwork(c, 64 * (h // 4) ** 2, 16)
    trn.load_state_dict(jax_to_torch_relation(variables))
    trn.train(train)
    got = trn(torch.from_numpy(x), torch.from_numpy(y))
    if train:
        diff = np.abs(x[:, :, None] - y[:, None])
        out, updated = jrn.module.apply(variables, jnp.asarray(diff.reshape(-1, h, h, c)),
                                        train=True, mutable=["batch_stats"])
        want = -np.asarray(out).reshape(bs, nq, ns)
        for i in range(2):
            stats = updated["batch_stats"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(trn.norms[i].running_mean.numpy(),
                                       np.asarray(stats["mean"]), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(trn.norms[i].running_var.numpy(),
                                       np.asarray(stats["var"]), rtol=1e-5, atol=1e-5)
    else:
        want = np.asarray(jrn.apply(variables, jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (bs, nq, ns) and bool((got < 0).all())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_new_modules_import_no_jax_and_no_sklearn():
    mods = ("nwhead_tpu_torch.eval", "nwhead_tpu_torch.ops.kmeans",
            "nwhead_tpu_torch.ops.influence", "nwhead_tpu_torch.ops.calibrate")
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nwhead_tpu', 'sklearn'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
