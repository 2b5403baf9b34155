"""The backward kernels of the ViT training slice, K8 and the K9 backward:
their plain versions against ``jax.grad`` through the JAX package's Pallas
kernels (interpret mode), and the port's autograd Functions against
autograd through the plain (``xla``) ops.

* ``_attention_qkv_bwd_plain`` against the VJP of
  ``nwhead_tpu.ops.pallas_attn.fused_attention_qkv`` (its single-pass
  backward ``_attn_qkv_bwd_kernel``), f32 and bf16, and against the chunked
  backward ``_attn_qkv_chunked_bwd_kernel`` forced by a small VMEM budget
  (f32; its delta is rowsum(dO * O), equal to the single pass's up to
  rounding in f32).
* ``_mlp_bwd_plain`` against the VJP of ``fused_mlp`` (``_mlp_bwd_kernel``),
  all five gradients, a ragged 2-D and a 3-D input. The port's GELU uses
  ``torch.erf``, the JAX kernel an approximation (absolute error 1.5e-7).

Gradients are held within 1e-5 (f32) or 1e-2 (bf16: dS, dh and P are
rounded to bf16, and a single flipped rounding moves a gradient by an ulp)
of the largest magnitude of each gradient. The kernels themselves are held
to these plain versions on the card (``tests/test_torch_vit_ops.py``,
marker ``gpu``, and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.models.vit import Attention, MlpBlock
from nwhead_tpu_torch.ops import fused_attn as FA
from nwhead_tpu_torch.ops import fused_mlp as FM

torch.set_num_threads(1)

REL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _jnp_dtype(prec):
    import jax.numpy as jnp

    return {"f32": jnp.float32, "bf16": jnp.bfloat16}[prec]


def _attn_case(B, N, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, 3, H, hd)).astype(np.float32),
            rng.standard_normal((B, N, H * hd)).astype(np.float32))


def _jax_attn_grad(qkv, g, H, prec):
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_attn import fused_attention_qkv

    dt = _jnp_dtype(prec)
    _, vjp = jax.vjp(lambda t: fused_attention_qkv(t, H), jnp.asarray(qkv).astype(dt))
    (dqkv,) = vjp(jnp.asarray(g).astype(dt))
    return _np(dqkv).reshape(qkv.shape[0], qkv.shape[1], -1)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 17, 2, 32), (1, 65, 6, 64), (2, 1, 2, 32), (1, 17, 2, 128),
                                   (1, 65, 2, 32)])
def test_attention_bwd_plain_matches_jax(shape, prec):
    B, N, H, hd = shape
    qkv, g = _attn_case(*shape)
    want = _jax_attn_grad(qkv, g, H, prec)
    dt = DTYPES[prec]
    qkv_t = torch.from_numpy(qkv).to(dt).reshape(B, N, 3 * H * hd)
    got = FA._attention_qkv_bwd_plain(qkv_t, torch.from_numpy(g).to(dt), H, hd ** -0.5)
    assert got.shape == qkv_t.shape and got.dtype == dt
    D = H * hd
    for part in range(3):  # dq, dk, dv
        cols = slice(part * D, (part + 1) * D)
        assert _rel_err(_np(got)[..., cols], want[..., cols]) <= REL[prec], part
    # The autograd Function's backward on CPU tensors is that plain version.
    leaf = torch.from_numpy(qkv).to(dt).requires_grad_(True)
    (through,) = torch.autograd.grad(FA.fused_attention_qkv(leaf, H), leaf,
                                     torch.from_numpy(g).to(dt))
    torch.testing.assert_close(through.reshape(got.shape), got, rtol=0, atol=0)


def test_attention_bwd_plain_matches_jax_chunked(monkeypatch):
    """JAX's long-N backward (``_attn_qkv_chunked_bwd_kernel``), forced with
    a 1 MiB VMEM budget and 64-key chunks, as
    ``tests/test_pallas_attn.py`` forces it."""
    import nwhead_tpu.ops.pallas_attn as pa

    B, N, H, hd = 2, 300, 2, 32
    monkeypatch.setattr(pa, "_VMEM_LIMIT", 1 * 1024 * 1024)
    monkeypatch.setattr(pa, "_FLASH_CHUNK", 64)
    assert pa._select_k_chunk(N, H * hd, 4) == 64
    qkv, g = _attn_case(B, N, H, hd, seed=3)
    want = _jax_attn_grad(qkv, g, H, "f32")
    got = FA._attention_qkv_bwd_plain(torch.from_numpy(qkv).reshape(B, N, -1),
                                      torch.from_numpy(g), H, hd ** -0.5)
    D = H * hd
    for part in range(3):
        cols = slice(part * D, (part + 1) * D)
        assert _rel_err(_np(got)[..., cols], want[..., cols]) <= REL["f32"], part


def _mlp_case(shape, D, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*shape, D)).astype(np.float32),
            (rng.standard_normal((D, Dh)) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.standard_normal(Dh)).astype(np.float32),
            (rng.standard_normal((Dh, D)) / np.sqrt(Dh)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            rng.standard_normal((*shape, D)).astype(np.float32))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [((37,), 64, 256), ((2, 13), 64, 256),  # ragged 2-D, and 3-D
                                   ((37,), 384, 1536), ((37,), 768, 3072)])  # ViT-S, ViT-B widths
def test_mlp_bwd_plain_matches_jax(shape, prec):
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.ops.pallas_mlp import fused_mlp

    shape, D, Dh = shape
    x, w1, b1, w2, b2, g = _mlp_case(shape, D, Dh)
    dt, jdt = DTYPES[prec], _jnp_dtype(prec)
    _, vjp = jax.vjp(lambda *a: fused_mlp(*a), jnp.asarray(x).astype(jdt), jnp.asarray(w1),
                     jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2))
    want = vjp(jnp.asarray(g).astype(jdt))
    leaves = [torch.from_numpy(x).to(dt)] + [torch.from_numpy(a) for a in (w1, b1, w2, b2)]
    for t in leaves:
        t.requires_grad_(True)
    out = FM.fused_mlp(*leaves)
    assert out.shape == x.shape and out.dtype == dt
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dt))
    for name, a, b, leaf in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want, leaves):
        assert a.shape == leaf.shape and a.dtype == leaf.dtype, name
        assert _rel_err(_np(a), _np(b)) <= REL[prec], name
    # The plain version called directly, in the kernel's operand dtypes.
    flat = (torch.from_numpy(x).to(dt).reshape(-1, D), torch.from_numpy(w1).to(dt),
            torch.from_numpy(b1), torch.from_numpy(w2).to(dt), torch.from_numpy(b2))
    direct = FM._mlp_bwd_plain(*flat, torch.from_numpy(g).to(dt).reshape(-1, D))
    assert [t.dtype for t in direct] == [dt, dt, torch.float32, dt, torch.float32]
    torch.testing.assert_close(direct[0].reshape(got[0].shape), got[0], rtol=0, atol=0)


def _module_pair(cls, *args, dtype=None):
    """The same module with the fused and the xla impl, equal weights
    drawn from a seed (LayerNorm-free, so no gamma matters here)."""
    key = "attn_impl" if cls is Attention else "mlp_impl"
    fused = cls(*args, dtype=dtype, **{key: "fused"})
    plain = cls(*args, dtype=dtype, **{key: "xla"})
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in fused.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    plain.load_state_dict(fused.state_dict())
    return fused, plain


@pytest.mark.parametrize("cls,args", [(Attention, (64, 2)), (MlpBlock, (64, 256, 64))],
                         ids=["attention", "mlp"])
def test_functions_match_autograd_through_xla(cls, args):
    """Each Function (the model's ``fused`` impl) against autograd through
    the model's ``xla`` ops, f32, on a module's input and every parameter
    (the gradients reach the f32 ``nn.Linear`` weights through the
    transposes and casts)."""
    fused, plain = _module_pair(cls, *args)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 13, 64), np.float32))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 13, 64), np.float32))
    grads = []
    for m in (fused, plain):
        leaf = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(m(leaf), [leaf, *m.parameters()], g))
    for a, b in zip(*grads):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel_err(_np(a), _np(b)) <= REL["f32"]


def test_bf16_functions_reach_f32_parameters():
    """In bf16 the model casts its f32 parameters to bf16 before the
    Functions; their gradients come back in f32 and agree with autograd
    through the xla ops within 2e-2 of max|grad| (the xla ops round the
    scores and the hidden layer to bf16 where the kernels keep f32)."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 13, 64), np.float32))
    for cls, args in ((Attention, (64, 2)), (MlpBlock, (64, 256, 64))):
        fused, plain = _module_pair(cls, *args, dtype=torch.bfloat16)
        grads = []
        for m in (fused, plain):
            out = m(x.to(torch.bfloat16))
            assert out.dtype == torch.bfloat16
            grads.append(torch.autograd.grad(out.float().square().sum(), list(m.parameters())))
        for p, a, b in zip(fused.parameters(), *grads):
            assert p.dtype == a.dtype == torch.float32
            assert _rel_err(_np(a), _np(b)) <= 2e-2, cls.__name__


def test_scale_and_head_layout_of_the_plain_backward():
    """The plain K8 backward on f32 inputs equals the textbook VJP of
    softmax(q k^T s) v taken by autograd in f64 (scale applied to dq and
    dk, q | k | v lanes in the packed layout), within 1e-5 of max|grad|."""
    rng = np.random.default_rng(11)
    B, N, H, hd = 1, 7, 2, 32
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * hd)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, N, H * hd)).astype(np.float32))
    scale = 0.3
    got = FA._attention_qkv_bwd_plain(qkv, g, H, scale)
    leaf = qkv.double().requires_grad_(True)
    x = leaf.reshape(B, N, 3, H, hd)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v
    (want,) = torch.autograd.grad(out.transpose(1, 2).reshape(B, N, H * hd), leaf, g.double())
    assert got.dtype == torch.float32
    D = H * hd
    for part in range(3):
        cols = slice(part * D, (part + 1) * D)
        assert _rel_err(_np(got)[..., cols], want.numpy()[..., cols]) <= REL["f32"], part
