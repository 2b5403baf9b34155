"""The port's ViT kernels' plain versions against the JAX package's Pallas
kernels (interpret mode), and the kernels against their plain versions on
the card.

* K7 ``fused_attention_qkv`` and the K9 forward ``fused_mlp``: f32 held at
  rtol=atol=1e-4 (measured: 3.1e-7 of max|JAX| and 6.0e-7 absolute), bf16
  at one bf16 ulp of max|JAX| (2^-7 relative; measured 0: the same bf16
  values), ragged N and M.
* K12 ``fused_attention`` (separate ``(B, H, N, hd)`` q, k, v; K7 over the
  packed q, k, v on the card) at the same tolerances, N ragged against the
  JAX kernel's padding to 16 rows.
* K10 ``fused_attention_block_bf16`` and K11 ``fused_mlp_block_bf16``,
  every combination of the LayerNorm, LayerScale and residual folds, at
  the same bf16 tolerance (measured 0). The GELU of the port is
  ``torch.erf``; the JAX kernels' erf approximation (absolute error
  1.5e-7) is inside every tolerance here.

The autograd Functions of K7 and K9 on CPU tensors run the plain K8 and K9
backward and match autograd through the plain forwards; their JAX
comparisons are in ``tests/test_torch_vit_train_ops.py``.

The CUDA kernels are tested on the card only (marker ``gpu``): each against
its plain version in its working dtype, f32 at 1e-4 of max|plain|, bf16 at
cosine >= 0.9999 and 1e-2 of max|plain| (the kernels sum in another order
than cuBLAS, so a bf16 rounding of a probability or an output may flip,
and flips propagate through the half-blocks); K8 and the K9 backward at
1e-3 (f32) and 2e-2 (bf16) of each gradient's max|plain|, and a ViT-S
block trained through them against the plain block. K7, K8 and K12 also
run at the edges of their tiles (``EDGE_SHAPES``: N of 1 to 1,370, every
head width, one batch row and 64), and K8 in bf16 must repeat bit for
bit. The GPU machine has no jax, so this module imports
the JAX package inside the tests that compare with it, and the GPU tests run
there with ``python -m pytest --noconftest -m gpu tests/test_torch_vit_ops.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.ops import fused_attn as FA
from nwhead_tpu_torch.ops import fused_mlp as FM

torch.set_num_threads(1)

BF16_REL = 2.0 ** -7  # one bf16 ulp of the largest value
FOLDS = list(itertools.product([False, True], repeat=3))  # (ln, layerscale, residual)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(x):
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _attn_inputs(B, N, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, N, 3, H, hd)).astype(np.float32)


def _mlp_inputs(M, D, Dh, seed=0, D_out=None):
    D_out = D if D_out is None else D_out
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, Dh)) / np.sqrt(D)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(Dh)).astype(np.float32)
    w2 = (rng.standard_normal((Dh, D_out)) / np.sqrt(Dh)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(D_out)).astype(np.float32)
    return x, w1, b1, w2, b2


def _block_inputs(D, D2, seed=0):
    """(w_a, b_a, w_b, b_b, ln_scale, ln_bias, ls): the two products of a
    half-block (D -> D2 -> D) and its folds, LayerScale of order 1."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((D, D2)) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D2)).astype(np.float32),
            (rng.standard_normal((D2, D)) / np.sqrt(D2)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            rng.uniform(0.5, 1.5, D).astype(np.float32))


def _dtype(prec):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[prec]


def _jnp_dtype(prec):
    import jax.numpy as jnp

    return {"f32": jnp.float32, "bf16": jnp.bfloat16}[prec]


def _check(got, want, prec):
    if prec == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    else:
        assert _rel_err(_f32(got), _f32(want)) <= BF16_REL


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 17, 2, 32), (1, 50, 2, 64), (2, 1, 2, 32), (1, 65, 2, 64),
                                   (1, 17, 2, 128)])
def test_attention_qkv_plain_matches_jax(shape, prec):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_attn import fused_attention_qkv as jax_attn

    B, N, H, hd = shape
    qkv = _attn_inputs(*shape)
    want = jax_attn(jnp.asarray(qkv).astype(_jnp_dtype(prec)), H)
    got = FA.fused_attention_qkv(torch.from_numpy(qkv).to(_dtype(prec)), H)
    assert got.shape == (B, N, H * hd) and got.dtype == _dtype(prec)
    _check(got, want, prec)


# (leading shape, D, D_h): M = 26 ragged against every tile, and a ragged M
# = 37 at ViT-S/14's and ViT-B's widths.
MLP_WIDTHS = {"": ((2, 13), 64, 256), "vit_s": ((37,), 384, 1536), "vit_b": ((37,), 768, 3072)}


@pytest.mark.parametrize("prec,width", [(p, w) for w in MLP_WIDTHS for p in ("f32", "bf16")],
                         ids=[f"{p}-{w}" if w else p for w in MLP_WIDTHS for p in ("f32", "bf16")])
def test_mlp_plain_matches_jax(prec, width):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_mlp import fused_mlp as jax_mlp

    lead, D, Dh = MLP_WIDTHS[width]
    x, w1, b1, w2, b2 = _mlp_inputs(int(np.prod(lead)), D, Dh)
    x = x.reshape(*lead, D)
    dt = _jnp_dtype(prec)
    want = jax_mlp(jnp.asarray(x).astype(dt), jnp.asarray(w1), jnp.asarray(b1),
                   jnp.asarray(w2), jnp.asarray(b2))
    got = FM.fused_mlp(torch.from_numpy(x).to(_dtype(prec)), *map(torch.from_numpy,
                                                                   (w1, b1, w2, b2)))
    assert got.shape == (*lead, D) and got.dtype == _dtype(prec)
    _check(got, want, prec)


def _fold_kwargs(ln, ls, residual, ln_scale, ln_bias, gamma, to):
    return dict(ln_scale=to(ln_scale) if ln else None, ln_bias=to(ln_bias) if ln else None,
                layerscale=to(gamma) if ls else None, residual=residual)


@pytest.mark.parametrize("ln,ls,residual", FOLDS)
def test_attention_block_bf16_plain_matches_jax(ln, ls, residual):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_attn import fused_attention_block_bf16 as jax_block

    D, H = 64, 2
    x = np.random.default_rng(3).standard_normal((2, 17, D)).astype(np.float32)
    w_qkv, b_qkv, _, b_proj, ln_s, ln_b, gamma = _block_inputs(D, 3 * D)
    w_proj = (np.random.default_rng(4).standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    want = jax_block(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w_qkv), jnp.asarray(b_qkv),
                     jnp.asarray(w_proj), jnp.asarray(b_proj), H,
                     **_fold_kwargs(ln, ls, residual, ln_s, ln_b, gamma, jnp.asarray))
    got = FA.fused_attention_block_bf16(
        torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, (w_qkv, b_qkv, w_proj,
                                                                          b_proj)), H,
        **_fold_kwargs(ln, ls, residual, ln_s, ln_b, gamma, torch.from_numpy))
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _check(got, want, "bf16")


@pytest.mark.parametrize("ln,ls,residual", FOLDS)
def test_mlp_block_bf16_plain_matches_jax(ln, ls, residual):
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_mlp import fused_mlp_block_bf16 as jax_block

    D = 64
    x = np.random.default_rng(5).standard_normal((2, 13, D)).astype(np.float32)
    w1, b1, w2, b2, ln_s, ln_b, gamma = _block_inputs(D, 4 * D, seed=1)
    want = jax_block(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
                     jnp.asarray(w2), jnp.asarray(b2),
                     **_fold_kwargs(ln, ls, residual, ln_s, ln_b, gamma, jnp.asarray))
    got = FM.fused_mlp_block_bf16(
        torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, (w1, b1, w2, b2)),
        **_fold_kwargs(ln, ls, residual, ln_s, ln_b, gamma, torch.from_numpy))
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _check(got, want, "bf16")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the public ops equal their plain versions and launch
    no kernel."""
    before = (FA.attention_qkv_cuda.launches, FA.attention_block_bf16_cuda.launches,
              FM.mlp_cuda.launches, FM.mlp_block_bf16_cuda.launches)
    qkv = torch.from_numpy(_attn_inputs(2, 9, 2, 32)).reshape(2, 9, 192)
    torch.testing.assert_close(FA.fused_attention_qkv(qkv, 2),
                               FA._attention_qkv_plain(qkv, 2, 32 ** -0.5), rtol=0, atol=0)
    x, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_inputs(11, 64, 128))
    torch.testing.assert_close(FM.fused_mlp(x, w1, b1, w2, b2), FM._mlp_plain(x, w1, b1, w2, b2),
                               rtol=0, atol=0)
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(
        FM.fused_mlp_block_bf16(xb, w1, b1, w2, b2, residual=True),
        FM._mlp_block_bf16_plain(xb, w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2,
                                 residual=True), rtol=0, atol=0)
    w = torch.from_numpy(_block_inputs(64, 192)[0])
    out = FA.fused_attention_block_bf16(xb.reshape(1, 11, 64), w, torch.zeros(192),
                                        torch.eye(64), torch.zeros(64), 2)
    assert out.shape == (1, 11, 64) and out.dtype == torch.bfloat16
    after = (FA.attention_qkv_cuda.launches, FA.attention_block_bf16_cuda.launches,
             FM.mlp_cuda.launches, FM.mlp_block_bf16_cuda.launches)
    assert after == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; they never
    compute on the CPU."""
    qkv = torch.zeros(1, 4, 192)
    with pytest.raises(ValueError, match="CUDA"):
        FA.attention_qkv_cuda(qkv, 2, 0.125)
    xb = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.attention_block_bf16_cuda(xb, w, torch.zeros(192), w[:, :64].contiguous(),
                                     torch.zeros(64), 2, 0.125, None, None, 1e-6, None, True)
    x, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_inputs(4, 64, 128))
    with pytest.raises(ValueError, match="CUDA"):
        FM.mlp_cuda(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        FM.mlp_bwd_cuda(x, w1, b1, w2, b2, torch.zeros(4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        FA.attention_qkv_bwd_cuda(qkv, torch.zeros(1, 4, 64), 2, 0.125)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        FM.mlp_block_bf16_cuda(x.to(bf), w1.to(bf), b1, w2.to(bf), b2, residual=True)


def test_gradients_flow_through_the_functions():
    """K7 and K9 are ``torch.autograd.Function``s: on CPU tensors their
    backward is the plain K8 and K9 backward, which equal autograd through
    the plain forward (f32, 1e-5 of max|grad|), and gradients reach f32
    weights through the transposes and casts ``models/vit.py`` applies.
    No kernel is launched."""
    before = (FA.attention_qkv_bwd_cuda.launches, FM.mlp_bwd_cuda.launches)
    qkv = torch.from_numpy(_attn_inputs(2, 9, 2, 32)).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 64), np.float32))
    (got,) = torch.autograd.grad(FA.fused_attention_qkv(qkv, 2), qkv, g)
    flat = qkv.detach().reshape(2, 9, 192).requires_grad_(True)
    (want,) = torch.autograd.grad(FA._attention_qkv_plain(flat, 2, 32 ** -0.5), flat, g)
    assert got.shape == (2, 9, 3, 2, 32)
    assert _rel_err(_f32(got).reshape(2, 9, 192), _f32(want)) <= 1e-5
    x, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_inputs(11, 64, 128))
    w1t, w2t = w1.t().contiguous().requires_grad_(True), w2.t().contiguous().requires_grad_(True)
    ins = [x.requires_grad_(True), w1t, b1.requires_grad_(True), w2t, b2.requires_grad_(True)]
    gy = torch.from_numpy(np.random.default_rng(2).standard_normal((11, 64), np.float32))
    got = torch.autograd.grad(FM.fused_mlp(x, w1t.t(), b1, w2t.t(), b2), ins, gy)
    want = torch.autograd.grad(FM._mlp_plain(x, w1t.t(), b1, w2t.t(), b2), ins, gy)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_err(_f32(a), _f32(b)) <= 1e-5
    assert (FA.attention_qkv_bwd_cuda.launches, FM.mlp_bwd_cuda.launches) == before


# --- on the card -------------------------------------------------------------


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 37, 32), (1, 2, 50, 64)])
def test_fused_attention_plain_matches_jax(shape, prec):
    """K12 ``fused_attention`` over separate ``(B, H, N, hd)`` q, k, v
    against JAX's (interpret mode), N ragged against its padding to 16
    rows: f32 within 1e-4 of max|JAX|, bf16 within one bf16 ulp of it."""
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_attn import fused_attention as jax_attn

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    want = jax_attn(*(jnp.asarray(x).astype(_jnp_dtype(prec)) for x in (q, k, v)))
    got = FA.fused_attention(*(torch.from_numpy(x).to(_dtype(prec)) for x in (q, k, v)))
    assert got.shape == shape and got.dtype == _dtype(prec)
    assert _rel_err(_f32(got), _f32(want)) <= (1e-4 if prec == "f32" else BF16_REL)
    scaled = FA.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3)
    want = jax_attn(*(jnp.asarray(x) for x in (q, k, v)), scale=0.3)
    assert _rel_err(_f32(scaled), _f32(want)) <= 1e-4


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The tile edges of K7, K8 and K12 (64-row blocks of four 16-row warps,
# 32- and 64-row steps, 8-key score tiles, 16-key bf16 PV steps): N on and
# off each edge, every head width, one batch row and a full batch.
# (B, N, H, hd).
EDGE_SHAPES = [(B, N, 2, hd) for B in (1, 64) for N in (1, 8, 16, 17, 64, 65, 257, 1370)
               for hd in (32, 64, 128)]


def _card_check(got, want, prec):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    if prec == "f32":
        assert rel <= 1e-4, rel
    else:
        cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
        assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 257, 6, 64), (8, 197, 6, 64), (2, 1370, 6, 64),
                                   (4, 257, 12, 64), (3, 50, 2, 32), (2, 70, 2, 128)]
                         + EDGE_SHAPES)
def test_cuda_attention_qkv_matches_plain(shape, prec):
    dev = _need_gpu()
    B, N, H, hd = shape
    qkv = torch.from_numpy(_attn_inputs(*shape)).to(dev, _dtype(prec)).reshape(B, N, 3 * H * hd)
    before = FA.attention_qkv_cuda.launches
    got = FA.fused_attention_qkv(qkv, H)
    want = FA._attention_qkv_plain(qkv, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert FA.attention_qkv_cuda.launches == before + 1
    _card_check(got, want, prec)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 6, 257, 64), (8, 6, 197, 64), (3, 2, 50, 32),
                                   (2, 2, 70, 128)] + [(B, H, N, hd) for B, N, H, hd in EDGE_SHAPES])
def test_cuda_fused_attention_matches_plain(shape, prec):
    """K12 on the card (K7's kernel on q, k, v by their strides) against
    its plain version; a head width K7 is not built for raises."""
    dev = _need_gpu()
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, _dtype(prec))
               for _ in range(3))
    before = FA.fused_attention_cuda.launches, FA.attention_qkv_cuda.launches
    got = FA.fused_attention(q, k, v)
    want = FA._attention_plain(q, k, v, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert (FA.fused_attention_cuda.launches, FA.attention_qkv_cuda.launches) == \
        (before[0] + 1, before[1])
    assert got.shape == shape and got.dtype == q.dtype
    _card_check(got, want, prec)
    with pytest.raises(ValueError, match="head width"):
        FA.fused_attention(q[..., :16], k[..., :16], v[..., :16])


# The tile edges of K9 and its backward (64-token blocks of four 16-row
# warps, 128-unit hidden chunks, 128- to 384-column output blocks, 32-deep
# slices) with ragged D_h and D_out (bf16 rows of 200 bytes, off cp.async's
# 16), and the ViT-S/14 training step's M. (M, D, D_h, D_out).
MLP_EDGE_SHAPES = [(M, 64, 100, 200) for M in (1, 15, 16, 17, 63, 64, 65, 129)] + [
    (310456, 384, 1536, 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16448, 384, 1536, 384), (1001, 384, 1536, 384),
                                   (514, 768, 3072, 768), (100, 1024, 4096, 1024),
                                   (37, 64, 100, 200)] + MLP_EDGE_SHAPES)
def test_cuda_mlp_matches_plain(shape, prec):
    dev = _need_gpu()
    M, D, Dh, D_out = shape
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(dev) for a in _mlp_inputs(M, D, Dh, D_out=D_out))
    dt = _dtype(prec)
    before = FM.mlp_cuda.launches
    got = FM.fused_mlp(x.to(dt), w1, b1, w2, b2)
    want = FM._mlp_plain(x.to(dt), w1.to(dt), b1, w2.to(dt), b2)
    torch.cuda.synchronize()
    assert FM.mlp_cuda.launches == before + 1
    _card_check(got, want, prec)


@pytest.mark.gpu
@pytest.mark.parametrize("ln,ls,residual", FOLDS)
@pytest.mark.parametrize("shape", [(8, 257, 384, 6), (2, 50, 768, 12)])
def test_cuda_attention_block_bf16_matches_plain(shape, ln, ls, residual):
    dev = _need_gpu()
    B, N, D, H = shape
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((B, N, D), np.float32))
    w_qkv, b_qkv, _, b_proj, ln_s, ln_b, gamma = _block_inputs(D, 3 * D)
    w_proj = (np.random.default_rng(4).standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (x.to(dev, torch.bfloat16), to(w_qkv), to(b_qkv), to(w_proj), to(b_proj), H)
    kw = _fold_kwargs(ln, ls, residual, ln_s, ln_b, gamma, to)
    before = FA.attention_block_bf16_cuda.launches
    got = FA.fused_attention_block_bf16(*args, **kw)
    saved = FA.attention_block_bf16_cuda
    FA.attention_block_bf16_cuda = FA._attention_block_bf16_plain
    try:
        want = FA.fused_attention_block_bf16(*args, **kw)
    finally:
        FA.attention_block_bf16_cuda = saved
    torch.cuda.synchronize()
    assert FA.attention_block_bf16_cuda.launches == before + 1
    _card_check(got, want, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("ln,ls,residual", FOLDS)
def test_cuda_mlp_block_bf16_matches_plain(ln, ls, residual):
    """K11 (FFMA, ``vit_mlp_block_forward``), with or without folds, against
    its plain version; it never launches K9's tensor-core kernel."""
    dev = _need_gpu()
    D = 384
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 257, D), np.float32))
    w1, b1, w2, b2, ln_s, ln_b, gamma = (torch.from_numpy(a).to(dev)
                                         for a in _block_inputs(D, 4 * D, seed=1))
    xb = x.to(dev, torch.bfloat16)
    kw = dict(ln_scale=ln_s if ln else None, ln_bias=ln_b if ln else None,
              layerscale=gamma if ls else None, residual=residual)
    before = FM.mlp_block_bf16_cuda.launches, FM.mlp_cuda.launches
    got = FM.fused_mlp_block_bf16(xb, w1, b1, w2, b2, **kw)
    saved = FM.mlp_block_bf16_cuda
    FM.mlp_block_bf16_cuda = FM._mlp_block_bf16_plain
    try:
        want = FM.fused_mlp_block_bf16(xb, w1, b1, w2, b2, **kw)
    finally:
        FM.mlp_block_bf16_cuda = saved
    torch.cuda.synchronize()
    assert (FM.mlp_block_bf16_cuda.launches, FM.mlp_cuda.launches) == (before[0] + 1, before[1])
    _card_check(got, want, "bf16")


# The backward kernels against their plain versions: gradients within 1e-3
# (f32) or 2e-2 (bf16) of max|plain| (bf16: dS, dh and P are rounded to
# bf16, and a sum in another order can flip one rounding).
GRAD_REL = {"f32": 1e-3, "bf16": 2e-2}


def _grad_check(got, want, prec):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    assert rel <= GRAD_REL[prec], rel


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 257, 6, 64), (8, 197, 6, 64), (8, 1370, 6, 64),
                                   (4, 257, 12, 64), (3, 50, 2, 32), (2, 70, 2, 128)]
                         + EDGE_SHAPES)
def test_cuda_attention_qkv_bwd_matches_plain(shape, prec):
    dev = _need_gpu()
    B, N, H, hd = shape
    dt = _dtype(prec)
    qkv = torch.from_numpy(_attn_inputs(*shape)).to(dev, dt).reshape(B, N, 3 * H * hd)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((B, N, H * hd), np.float32))
    g = g.to(dev, dt)
    before = FA.attention_qkv_bwd_cuda.launches
    got = FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5)
    want = FA._attention_qkv_bwd_plain(qkv, g, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert FA.attention_qkv_bwd_cuda.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == dt
    D = H * hd
    for part in range(3):  # dq, dk, dv each against its own max
        _grad_check(got[..., part * D:(part + 1) * D], want[..., part * D:(part + 1) * D], prec)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 257, 6, 64), (2, 1370, 2, 128), (3, 65, 2, 32)])
def test_cuda_attention_qkv_bwd_repeats_bitwise(shape):
    """K8 in bf16 run twice on the same inputs gives the same dqkv bit for
    bit: every output element has one owner and its sums a fixed order (no
    atomics)."""
    dev = _need_gpu()
    B, N, H, hd = shape
    bf = torch.bfloat16
    qkv = torch.from_numpy(_attn_inputs(*shape)).to(dev, bf).reshape(B, N, 3 * H * hd)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((B, N, H * hd), np.float32))
    g = g.to(dev, bf)
    first = FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5)
    second = FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16448, 384, 1536, 384), (1001, 384, 1536, 384),
                                   (514, 768, 3072, 768), (100, 1024, 4096, 1024),
                                   (37, 64, 100, 200)] + MLP_EDGE_SHAPES)
def test_cuda_mlp_bwd_matches_plain(shape, prec):
    """The K9 backward against its plain version; run twice it gives the
    same five gradients bit for bit (fixed-order sums, no atomics)."""
    dev = _need_gpu()
    M, D, Dh, D_out = shape
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(dev) for a in _mlp_inputs(M, D, Dh, D_out=D_out))
    dt = _dtype(prec)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((M, D_out), np.float32))
    args = (x.to(dt), w1.to(dt), b1, w2.to(dt), b2, g.to(dev, dt))
    before = FM.mlp_bwd_cuda.launches
    got = FM.mlp_bwd_cuda(*args)
    again = FM.mlp_bwd_cuda(*args)
    want = FM._mlp_bwd_plain(*args)
    torch.cuda.synchronize()
    assert FM.mlp_bwd_cuda.launches == before + 2
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and a.dtype == b.dtype
        _grad_check(a, b, prec)
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_cuda_vit_block_trains_on_the_kernels():
    """A ViT-S block in f32 with the fused impls on the card: one backward
    launches K8 and the K9 backward once each, and every parameter gradient
    agrees with the plain (xla) block's within 1e-3 of its max."""
    from nwhead_tpu_torch.models.vit import Block

    dev = _need_gpu()
    gen = torch.Generator().manual_seed(0)
    blocks = [Block(384, 6, layerscale_init=1.0, attn_impl=impl, mlp_impl=impl)
              for impl in ("fused", "xla")]
    for p in blocks[0].parameters():
        p.data.normal_(0.0, 0.05, generator=gen)
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 257, 384), np.float32))
    before = (FA.attention_qkv_bwd_cuda.launches, FM.mlp_bwd_cuda.launches)
    grads = []
    for blk in blocks:
        blk.to(dev)
        out = blk(x.to(dev))
        grads.append(torch.autograd.grad(out.float().square().sum(), list(blk.parameters())))
    torch.cuda.synchronize()
    assert (FA.attention_qkv_bwd_cuda.launches, FM.mlp_bwd_cuda.launches) == tuple(
        n + 1 for n in before)
    for a, b in zip(*grads):
        _grad_check(a, b, "f32")
