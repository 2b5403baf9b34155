"""The port's int8 ViT serving stack against the JAX package: the int8
half-blocks (K10 int8, K11 int8), the calibration and quantization of a ViT
(``models/quantize.py``), the weights carried across
(``jax_to_torch_quantized_vit``) and the slice end to end.

* Plain ``fused_attention_qkv_int8`` and ``fused_mlp_int8`` against JAX's
  Pallas kernels (interpret mode) on the same int8 weights and scales,
  every combination of the LayerNorm, LayerScale and residual folds: within
  1e-2 of max|JAX| (a bf16 ulp upstream can move a code by one); measured
  bit-equal, and the share of equal elements is printed.
* ``quantize_vit``'s activation amaxes within rtol 1e-5 of JAX's (two f32
  calibration forwards), its weight codes and scales equal.
* The port's ``QuantizedViT`` carried across from JAX's, against
  ``QuantizedViT.apply`` on the same images.
* ``NWNet.quantize_featurizer`` + ``precompute`` + ``predict('full')`` with
  an int8 and an int4 bank against JAX's, on the reduced ViT and dataset of
  ``tests/test_torch_vit_serve_slice.py``.

The CUDA kernels are tested on the card only (marker ``gpu``), against
their plain versions within 1e-2 of max|plain| and cosine >= 0.9999, K10
int8 also at the edges of its tiles; K11 int8 and K10 int8's qkv stage
alone, whose int32 sums are exact, equal their plain versions bit for bit,
and K10 int8 and K11 int8 repeat bit for bit. K10 int8's qkv stage's plain
version is also held to JAX's ``QLayerNorm`` and ``QDense``. They run with ``python -m pytest --noconftest -m gpu
tests/test_torch_quant_vit.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_attn as FA
from nwhead_tpu_torch.ops import fused_mlp as FM

torch.set_num_threads(1)

FOLDS = list(itertools.product([False, True], repeat=3))  # (ln, layerscale, residual)
REL = 1e-2


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _qweight(rng, din, dout):
    """An int8 Dense as ``quantize_vit`` makes one: per-column scales."""
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    amax = np.abs(w).max(0)
    scale = np.where(amax > 0, amax / np.float32(127.0), 1.0).astype(np.float32)
    return (np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale,
            (0.1 * rng.standard_normal(dout)).astype(np.float32))


def _block(D, Dh, seed=0):
    """Weights of an int8 half-block pair and its folds; activation scales
    of the order calibration gives unit-variance inputs."""
    rng = np.random.default_rng(seed)
    return dict(
        qkv=_qweight(rng, D, 3 * D), proj=_qweight(rng, D, D), fc1=_qweight(rng, D, Dh),
        fc2=_qweight(rng, Dh, D), ln_s=(1 + 0.2 * rng.standard_normal(D)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(D)).astype(np.float32),
        gamma=rng.uniform(0.5, 1.5, D).astype(np.float32),
        a=[float(np.float32(v / 127.0)) for v in (5.0, 2.0, 5.0, 3.0)])


def _folds(p, ln, ls, residual, to):
    return dict(ln_scale=to(p["ln_s"]) if ln else None, ln_bias=to(p["ln_b"]) if ln else None,
                layerscale=to(p["gamma"]) if ls else None, residual=residual)


def _attn_args(p, to):
    (wq, sq, bq), (wp, sp, bp) = p["qkv"], p["proj"]
    return (to(wq), to(sq), to(bq), p["a"][0], to(wp), to(sp), to(bp), p["a"][1])


def _mlp_args(p, to):
    (w1, s1, b1), (w2, s2, b2) = p["fc1"], p["fc2"]
    return (to(w1), to(s1), to(b1), p["a"][2], to(w2), to(s2), to(b2), p["a"][3])


def _x_bf16(shape, seed):
    """Unit-normal inputs rounded to bf16, as f32 numpy."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("ln,ls,residual", FOLDS)
def test_attention_block_int8_plain_matches_jax(ln, ls, residual):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_attn import fused_attention_qkv_int8

    p = _block(64, 256)
    x = _x_bf16((2, 17, 64), seed=1)
    want = fused_attention_qkv_int8(jnp.asarray(x, jnp.bfloat16), *_attn_args(p, jnp.asarray), 2,
                                    **_folds(p, ln, ls, residual, jnp.asarray))
    got = FA.fused_attention_qkv_int8(torch.from_numpy(x), *_attn_args(p, torch.from_numpy), 2,
                                      **_folds(p, ln, ls, residual, torch.from_numpy))
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    print(f"K10 int8 plain vs JAX: {np.mean(got == want):.4f} of elements bit-equal")
    assert _rel_err(got, want) <= REL


# (leading shape, D, D_h) of the MLP half-block cases beyond the folds' (2,
# 17) tokens at D = 64, D_h = 256: ViT-S/14's width, and a ragged D_h, every
# fold on. K11 int8 on the card equals these plain versions bit for bit.
MLP_WIDTHS = {"": ((2, 17), 64, 256), "vit_s": ((37,), 384, 1536), "dh100": ((2, 17), 64, 100)}
MLP_CASES = [pytest.param(ln, ls, residual, "", id=f"{ln}-{ls}-{residual}")
             for ln, ls, residual in FOLDS] + [
    pytest.param(True, True, True, w, id=f"{w}-all_folds") for w in ("vit_s", "dh100")]


@pytest.mark.parametrize("ln,ls,residual,width", MLP_CASES)
def test_mlp_block_int8_plain_matches_jax(ln, ls, residual, width):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_mlp import fused_mlp_int8

    lead, D, Dh = MLP_WIDTHS[width]
    p = _block(D, Dh)
    x = _x_bf16((*lead, D), seed=2)
    want = fused_mlp_int8(jnp.asarray(x, jnp.bfloat16), *_mlp_args(p, jnp.asarray),
                          **_folds(p, ln, ls, residual, jnp.asarray))
    got = FM.fused_mlp_int8(torch.from_numpy(x), *_mlp_args(p, torch.from_numpy),
                            **_folds(p, ln, ls, residual, torch.from_numpy))
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    assert got.shape == want.shape
    print(f"K11 int8 plain vs JAX: {np.mean(got == want):.4f} of elements bit-equal")
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("ln", [False, True])
def test_qkv_proj_int8_plain_matches_jax(ln):
    """K10 int8's qkv stage alone (``_qkv_proj_int8_plain``, f32) rounded to
    bf16 against JAX's ``QDense`` (after its ``QLayerNorm``) on the same
    weights and scale."""
    import jax.numpy as jnp

    from nwhead_tpu.models.quantize import QDense, QLayerNorm

    p = _block(64, 256)
    (wq, sq, bq), a = p["qkv"], p["a"][0]
    x = _x_bf16((2, 17, 64), seed=9)
    h = jnp.asarray(x, jnp.bfloat16)
    if ln:
        h = QLayerNorm(jnp.asarray(p["ln_s"]), jnp.asarray(p["ln_b"]))(h)
    want = QDense(jnp.asarray(wq), jnp.asarray(sq), jnp.asarray(bq), jnp.float32(a))(h)
    to = torch.from_numpy
    got = FA._qkv_proj_int8_plain(to(x).to(torch.bfloat16), to(wq), to(sq), to(bq), a,
                                  to(p["ln_s"]) if ln else None, to(p["ln_b"]) if ln else None,
                                  1e-6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 17, 192)
    want, got = np.asarray(want.astype(jnp.float32)), got.to(torch.bfloat16).float().numpy()
    print(f"K10 int8 qkv stage plain vs JAX: {np.mean(got == want):.4f} of elements bit-equal")
    assert _rel_err(got, want) <= REL


def test_qkv_proj_int8_cuda_refuses_what_it_cannot_take():
    """K10 int8's qkv stage alone launches on CUDA tensors of its shapes or
    raises."""
    p = _block(64, 256)
    (wq, sq, bq), to = p["qkv"], torch.from_numpy
    x = torch.zeros(1, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.qkv_proj_int8_cuda(x, to(wq), to(sq), to(bq), 0.04, None, None, 1e-6)
    with pytest.raises(ValueError, match="multiple of 4"):
        FA.qkv_proj_int8_cuda(x[..., :62], to(wq)[:62], to(sq), to(bq), 0.04, None, None, 1e-6)
    with pytest.raises(ValueError, match="not"):
        FA.qkv_proj_int8_cuda(x, to(wq)[:32], to(sq), to(bq), 0.04, None, None, 1e-6)


def test_int8_wrappers_refuse_cpu_tensors():
    """The K10/K11 int8 wrappers launch on CUDA tensors or raise."""
    p = _block(64, 256)
    to = torch.from_numpy
    x = torch.zeros(1, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.attention_block_int8_cuda(x, *_attn_args(p, to), 2, 0.125, None, None, 1e-6, None,
                                     False)
    with pytest.raises(ValueError, match="CUDA"):
        FM.mlp_block_int8_cuda(x[0], *_mlp_args(p, to))


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_check(got, want):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
    assert rel <= REL and cos >= 0.9999, (rel, cos)


# K10 int8's shapes on the card, (B, N, D, H): eight images at ViT-S/14's
# width, ViT-B/14's, heads of 32, and the edges of its 64-query tiles and
# of its projections' 128-row tiles (one image, heads of 64).
ATTN_INT8_SHAPES = [(8, 257, 384, 6), (2, 50, 768, 12), (3, 37, 64, 2)] + [
    (1, n, 384, 6) for n in (1, 63, 64, 65, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("ln,ls,residual", FOLDS)
@pytest.mark.parametrize("shape", ATTN_INT8_SHAPES)
def test_cuda_attention_block_int8_matches_plain(shape, ln, ls, residual):
    dev = _need_gpu()
    B, N, D, H = shape
    p = _block(D, 4 * D, seed=3)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x = to(_x_bf16((B, N, D), seed=4)).to(torch.bfloat16)
    args, kw = (x, *_attn_args(p, to), H), _folds(p, ln, ls, residual, to)
    before = FA.attention_block_int8_cuda.launches
    got = FA.fused_attention_qkv_int8(*args, **kw)
    saved = FA.attention_block_int8_cuda
    FA.attention_block_int8_cuda = FA._attention_block_int8_plain
    try:
        want = FA.fused_attention_qkv_int8(*args, **kw)
    finally:
        FA.attention_block_int8_cuda = saved
    torch.cuda.synchronize()
    assert FA.attention_block_int8_cuda.launches == before + 1
    _card_check(got, want)


@pytest.mark.gpu
def test_cuda_attention_block_int8_repeats_bit_for_bit():
    """K10 int8 with every fold: two runs, the same bits."""
    dev = _need_gpu()
    p = _block(384, 1536, seed=10)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x = to(_x_bf16((3, 257, 384), seed=11)).to(torch.bfloat16)
    args, kw = (x, *_attn_args(p, to), 6), _folds(p, True, True, True, to)
    first, second = FA.fused_attention_qkv_int8(*args, **kw), FA.fused_attention_qkv_int8(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("shape", ATTN_INT8_SHAPES[:4] + [(64, 257, 384, 6)])
def test_cuda_qkv_proj_int8_is_bit_equal_to_plain(shape, ln):
    """K10 int8's qkv stage alone (the codes' prologue, the s8 ``mma.sync``
    GEMM with exact int32 sums, the dequantized sum) equals
    ``int8_dense_f32(quantize_act(...))`` bit for bit."""
    dev = _need_gpu()
    B, N, D, _ = shape
    p = _block(D, 4 * D, seed=12)
    (wq, sq, bq), a = p["qkv"], p["a"][0]
    to = lambda t: torch.from_numpy(t).to(dev)  # noqa: E731
    x = to(_x_bf16((B, N, D), seed=13)).to(torch.bfloat16)
    ln_args = (to(p["ln_s"]) if ln else None, to(p["ln_b"]) if ln else None, 1e-6)
    before = FA.qkv_proj_int8_cuda.launches
    got = FA.qkv_proj_int8_cuda(x, to(wq), to(sq), to(bq), a, *ln_args)
    want = FA._qkv_proj_int8_plain(x, to(wq), to(sq), to(bq), a, *ln_args)
    torch.cuda.synchronize()
    assert FA.qkv_proj_int8_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, N, 3 * D)
    assert torch.equal(got, want), float((got == want).double().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("ln,ls,residual", FOLDS)
@pytest.mark.parametrize("shape", [(64 * 257, 384, 1536), (8 * 257, 384, 1536), (1001, 768, 3072),
                                   (37, 64, 100), (1001, 388, 100)])
def test_cuda_mlp_block_int8_matches_plain(shape, ln, ls, residual):
    """K11 int8 (int8 ``mma.sync``, exact int32 sums) equals its plain
    version bit for bit: at the serving shape, eight images, ViT-B's width,
    a ragged D_h and a D_in off the 16-byte row (388)."""
    dev = _need_gpu()
    M, D, Dh = shape
    p = _block(D, Dh, seed=5)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x = to(_x_bf16((M, D), seed=6)).to(torch.bfloat16)
    args, kw = (x, *_mlp_args(p, to)), _folds(p, ln, ls, residual, to)
    before = FM.mlp_block_int8_cuda.launches
    got = FM.fused_mlp_int8(*args, **kw)
    saved = FM.mlp_block_int8_cuda
    FM.mlp_block_int8_cuda = FM._mlp_block_int8_plain
    try:
        want = FM.fused_mlp_int8(*args, **kw)
    finally:
        FM.mlp_block_int8_cuda = saved
    torch.cuda.synchronize()
    assert FM.mlp_block_int8_cuda.launches == before + 1
    _card_check(got, want)
    assert torch.equal(got, want), float((got == want).float().mean())


@pytest.mark.gpu
def test_cuda_mlp_block_int8_repeats_bit_for_bit():
    """K11 int8 with every fold: two runs, the same bits."""
    dev = _need_gpu()
    p = _block(384, 1536, seed=7)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x = to(_x_bf16((1001, 384), seed=8)).to(torch.bfloat16)
    args, kw = (x, *_mlp_args(p, to)), _folds(p, True, True, True, to)
    first, second = FM.fused_mlp_int8(*args, **kw), FM.fused_mlp_int8(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------------------------------------------
# Calibration, weights carried across, and the slice end to end (small ViT).
# ---------------------------------------------------------------------------

SMALL = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=48)


def _jax_vit():
    """JAX's small ViT with LayerScale gammas of order 1 (numpy variables)
    and the port's ``VisionTransformer`` carrying the same weights."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.models import vit as jvit
    from nwhead_tpu_torch.models import vit as tvit
    from nwhead_tpu_torch.models.convert import jax_to_torch_vit

    model = jvit.VisionTransformer(**SMALL)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    rng = np.random.default_rng(7)
    for i in range(SMALL["depth"]):
        for g in ("ls1_gamma", "ls2_gamma"):
            variables["params"][f"block{i}"][g] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    tmodel = tvit.VisionTransformer(**SMALL)
    tmodel.load_state_dict(jax_to_torch_vit(variables))
    return model, variables, tmodel.eval()


def _images(n, seed):
    from nwhead_tpu.data.datasets import make_synthetic_dataset

    return make_synthetic_dataset(n=n, n_classes=4, size=32, seed=seed).gather(np.arange(n))


def test_calibration_and_weights_match_jax():
    """``quantize_vit``'s activation scales within rtol 1e-5 of JAX's (two
    f32 calibration forwards, batches of 8 with a running max), its weight
    codes and per-channel scales equal."""
    from nwhead_tpu.models.quantize import quantize_vit as jax_quantize_vit
    from nwhead_tpu_torch.models.quantize import quantize_vit

    model, variables, tmodel = _jax_vit()
    calib = _images(20, seed=3)
    jq = jax_quantize_vit(model, variables, calib, calib_batch=8)
    tq = quantize_vit(tmodel, calib, calib_batch=8)
    for jb, tb in zip(jq.blocks, tq.blocks):
        for name in ("qkv", "proj", "fc1", "fc2"):
            jd, td = getattr(jb, name), getattr(tb, name)
            np.testing.assert_allclose(td.act_scale, float(jd.act_scale), rtol=1e-5)
            np.testing.assert_array_equal(td.wq.numpy(), np.asarray(jd.wq))
            np.testing.assert_array_equal(td.w_scale.numpy(), np.asarray(jd.w_scale))
            np.testing.assert_array_equal(td.bias.numpy(), np.asarray(jd.bias))


def test_carried_across_matches_jax_apply():
    """The port's ``QuantizedViT`` carried across from JAX's runs the same
    int8 weights and scales: features within 1e-2 of max|JAX|, and one
    ``QDense`` on its own equal to JAX's."""
    import jax.numpy as jnp

    from nwhead_tpu.models.quantize import quantize_vit as jax_quantize_vit
    from nwhead_tpu_torch.models.convert import jax_to_torch_quantized_vit

    model, variables, _ = _jax_vit()
    jq = jax_quantize_vit(model, variables, _images(16, seed=3), calib_batch=8)
    tq = jax_to_torch_quantized_vit(jq)
    x = _images(6, seed=4)
    want = np.asarray(jq.apply(jnp.asarray(x)))
    got = tq(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 64) and np.isfinite(got).all()
    print(f"carried-across QuantizedViT vs JAX: rel {_rel_err(got, want):.2e}, "
          f"{np.mean(got == want):.4f} of elements bit-equal")
    assert _rel_err(got, want) <= REL
    h = _x_bf16((5, 64), seed=5)
    jd, td = jq.blocks[0].fc1, tq.blocks[0].fc1
    np.testing.assert_array_equal(
        td(torch.from_numpy(h)).float().numpy(),
        np.asarray(jd(jnp.asarray(h, jnp.bfloat16)).astype(jnp.float32)))


@pytest.mark.parametrize("head_precision", ["int8", "int4"])
def test_quantized_slice_matches_jax(head_precision):
    """``NWNet.quantize_featurizer`` + ``precompute`` + the serving function
    against JAX's ``NWNet.quantize_featurizer`` + ``precompute`` +
    ``predict('full')`` on the same weights: probabilities within 2e-3,
    equal argmax; the bank and the queries went through the quantized
    featurizer."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.data.datasets import make_synthetic_dataset as jax_make_synthetic
    from nwhead_tpu.models import vit as jvit
    from nwhead_tpu.nw.net import NWNet as JaxNWNet
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models import vit as tvit
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
    from nwhead_tpu_torch.models.quantize import QuantizedViT
    from nwhead_tpu_torch.nw.net import NWNet

    train = jax_make_synthetic(n=64, n_classes=4, size=32, seed=0)
    val = jax_make_synthetic(n=32, n_classes=4, size=32, seed=1)
    jnet = JaxNWNet(jvit.VisionTransformer(**SMALL), 4, support_dataset=train, feat_dim=64,
                    fused_min_support=1, head_precision=head_precision)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(train.gather(np.arange(4)))))
    rng = np.random.default_rng(7)
    for i in range(SMALL["depth"]):
        for g in ("ls1_gamma", "ls2_gamma"):
            variables["params"]["featurizer"][f"block{i}"][g] = rng.uniform(
                0.5, 1.5, 64).astype(np.float32)
    calib = train.gather(np.arange(32))
    jnet.quantize_featurizer(variables, calib)
    jnet.precompute(variables)
    x = val.gather(np.arange(16))
    want = np.exp(np.asarray(jnet.predict(variables, jnp.asarray(x), "full")))

    tnet = NWNet(tvit.VisionTransformer(**SMALL), 4,
                 support_dataset=make_synthetic_dataset(n=64, n_classes=4, size=32, seed=0),
                 device="cpu", feat_dim=64, fused_min_support=1, head_precision=head_precision)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(variables))
    tnet.quantize_featurizer(calib)
    assert isinstance(tnet.serving_featurizer, QuantizedViT) and tnet._prepared_full is None
    tnet.precompute()
    assert tnet._prepared_full.s.dtype == {"int8": torch.int8, "int4": torch.uint8}[head_precision]
    got = torch.exp(tnet.make_serving_fn()(x)).numpy()
    assert got.shape == (16, 4) and np.isfinite(got).all()
    print(f"quantized slice ({head_precision} bank) vs JAX: max|dp| {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    with torch.inference_mode():
        float_feats = tnet.model.featurize(torch.from_numpy(x))
        served_feats = tnet._featurize_eval(torch.from_numpy(x))
    assert not torch.equal(float_feats, served_feats)


def test_serve_builds_the_int8_stack_on_cpu():
    """``--featurizer_precision int8 --head_precision int4``: the serve
    module calibrates on the first ``--calib_images`` training images before
    the bank, serves through the plain K10/K11 int8 and K5 on the CPU, and
    its report names both precisions."""
    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.models.quantize import QuantizedViT
    from nwhead_tpu_torch.ops import fused_nw

    args = serve.parse_args(["--device", "cpu", "--dataset", "synthetic", "--arch", "vit_s16",
                             "--featurizer_precision", "int8", "--head_precision", "int4",
                             "--calib_images", "16", "--batch_size", "8", "--latency_bench",
                             "--bench_batches", "2"])
    train_ds, val_ds = serve.build_datasets(args)
    net = serve.build_server(args, train_ds)
    assert isinstance(net.serving_featurizer, QuantizedViT)
    assert net.calibration_seconds > 0 and net._prepared_full.s.dtype == torch.uint8
    before = fused_nw.nw_prepared_int4_cuda.launches, FA.attention_block_int8_cuda.launches
    report = serve.latency_bench(net, val_ds, args)
    assert report["batches"] == 2 and report["p50_ms"] > 0
    assert (report["featurizer_precision"], report["head_precision"]) == ("int8", "int4")
    assert (fused_nw.nw_prepared_int4_cuda.launches,
            FA.attention_block_int8_cuda.launches) == before  # plain versions on the CPU


@pytest.mark.parametrize("arch,kw", [("CIFAR_ResNet10", {}), ("CIFAR_DenseNet121", {})])
def test_quantize_featurizer_refuses_the_cifar_models(arch, kw):
    """JAX refuses the CIFAR ResNets and DenseNet; so does the port."""
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    net = NWNet(load_model(arch, device="cpu", **kw), 4, device="cpu")
    with pytest.raises(NotImplementedError, match="CIFAR"):
        net.quantize_featurizer(np.zeros((2, 32, 32, 3), np.float32))
    assert net.serving_featurizer is None


def test_quantize_featurizer_refuses_the_s2d_stem():
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    net = NWNet(load_model("resnet10", device="cpu", stem="s2d"), 4, device="cpu")
    with pytest.raises(NotImplementedError, match="conv7"):
        net.quantize_featurizer(np.zeros((2, 32, 32, 3), np.float32))


def _served_net(arch, swap):
    """A CPU ``NWNet`` over a small synthetic bank, its featurizer swapped by
    ``swap`` (``quantize_featurizer`` or ``fuse_featurizer``)."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=24, n_classes=3, size=32, seed=0)
    model = load_model(arch, device="cpu", generator=torch.Generator().manual_seed(0))
    net = NWNet(model, 3, support_dataset=ds, device="cpu", n_shot_full=4, fused_min_support=1)
    if swap == "quantize_featurizer":
        net.quantize_featurizer(ds.gather(np.arange(8)))
    else:
        net.fuse_featurizer()
    return net, ds.gather(np.arange(4))


@pytest.mark.parametrize("arch,swap", [("resnet10", "quantize_featurizer"),
                                       ("vit_s16", "fuse_featurizer")])
def test_serving_featurizer_refuses_stale_weights(arch, swap):
    """The serving featurizer bakes in the weights it was built from, as in
    JAX (``_check_quantized_variables``): after ``load_state_dict`` of
    equal weights precompute, predict and the serving function run on;
    after other weights they raise, naming ``quantize_featurizer``."""
    net, x = _served_net(arch, swap)
    net.precompute()
    want = net.predict(x, "full")
    same = {k: v.clone() for k, v in net.model.state_dict().items()}
    net.model.load_state_dict(same)
    assert torch.equal(net.predict(x, "full"), want)
    net.precompute()
    serve = net.make_serving_fn()
    assert torch.equal(serve(x), want)
    net.model.load_state_dict({k: v + 1 for k, v in same.items()})
    for call in (net.precompute, lambda: net.predict(x, "full"), lambda: serve(x),
                 net.make_serving_fn):
        with pytest.raises(RuntimeError, match="quantize_featurizer"):
            call()
    getattr(net, swap)(*([x] if swap == "quantize_featurizer" else []))
    net.precompute()
    assert torch.isfinite(net.predict(x, "full")).all()
