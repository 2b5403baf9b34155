"""Fused transformer MLP: ``fc1 -> exact GELU -> fc2`` forward (K9), its
backward (the K9 backward) and the bf16 and int8 MLP half-blocks (K11).

Port of ``nwhead_tpu/ops/pallas_mlp.py``: ``fused_mlp`` (forward and
backward), ``fused_mlp_block_bf16`` (``quant=False``) and
``fused_mlp_int8`` (``quant=True``). Each runs a CUDA C++ kernel for
Hopper. K9 is ``csrc/vit_mlp.cu`` ``vit_mlp_forward`` (TPU
``_mlp_kernel``) on the tensor cores, the hidden activation never leaving
the chip. K11 is ``vit_mlp_block_forward`` in the same source (TPU
``_mlp_int8_kernel``, FFMA), which adds the optional LayerNorm before fc1
and the LayerScale and residual after fc2. K11 int8 is
``vit_mlp_int8_forward``: both products on int8 codes with calibrated
activation scales, the hidden chunk requantized on chip. The backward is
``csrc/vit_mlp_bwd.cu`` ``vit_mlp_backward`` (TPU ``_mlp_bwd_kernel``) on
the tensor cores: h and dg per tile of tokens and hidden units, g and dh
written once, rounded; then dx, and the weight and bias gradients summed
over all tokens in a fixed order.

Each kernel has a wrapper that counts its launches (``.launches``) and a
plain PyTorch version (``_mlp_plain``, ``_mlp_bwd_plain``,
``_mlp_block_bf16_plain``, ``_mlp_block_int8_plain``, whose integer
products are exact) with the TPU kernel's rounding points.
``fused_mlp`` is a ``torch.autograd.Function`` that saves its inputs, as
the JAX custom VJP does. The exact GELU uses ``torch.erf`` here and
``erff`` in the kernels; the JAX kernels use an approximation of erf
(Abramowitz & Stegun 7.1.26, absolute error 1.5e-7), which the tests'
tolerances cover. The int8 mode, whose GELU output is rounded to codes,
uses the JAX kernel's approximation in both versions (``_gelu_as``). A
CPU tensor goes to the plain versions, a CUDA tensor to the kernels, with
no fallback between them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops.fused_attn import (
    _check_cuda, _layer_norm_f32, _layer_norm_int8, _ptr, _vec, int8_dense_f32, quantize_act,
)

_BF16 = torch.bfloat16


def _gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


def _gelu_as(h: torch.Tensor) -> torch.Tensor:
    """The exact GELU of the TPU int8 MLP kernel, erf by Abramowitz & Stegun
    7.1.26 (``pallas_mlp.py:_erf``), in its order of operations, f32."""
    x = h * (0.5 ** 0.5)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
        -1.453152027 + t * 1.061405429))))
    return 0.5 * h * (1.0 + torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax)))


def _mlp_f32(x: torch.Tensor, w1, b1, w2, b2, dtype: torch.dtype) -> torch.Tensor:
    """``gelu(x w1 + b1)`` rounded to ``dtype``, ``@ w2 + b2``, in f32."""
    f32 = torch.float32
    h = _gelu_exact(torch.matmul(x.to(f32), w1.to(f32)) + b1.to(f32))
    return torch.matmul(h.to(dtype).to(f32), w2.to(f32)) + b2.to(f32)


def _mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    """K9's function in plain PyTorch on ``(M, D_in)``: weights in x's
    dtype, biases f32, products in f32, the GELU output rounded to x's
    dtype, out in x's dtype."""
    return _mlp_f32(x, w1, b1, w2, b2, x.dtype).to(x.dtype)


_INV_SQRT_2PI = 0.3989422804014327


def _mlp_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, dout: torch.Tensor):
    """The K9 backward in plain PyTorch (``_mlp_bwd_kernel``'s rounding
    points) on ``(M, D_in)`` x and ``(M, D_out)`` dO (rounded to x's
    dtype): h recomputed in f32; cdf = (1 + erf(h / sqrt 2)) / 2; g = h cdf
    rounded to x's dtype; dg = dO w2^T in f32; dh = dg (cdf + h phi(h))
    rounded to x's dtype; dx = dh w1^T in x's dtype; dw1 = x^T dh, dw2 =
    g^T dO, db1 = sum dh, db2 = sum dO, summed in f32, in the weights' and
    biases' dtypes. Returns ``(dx, dw1, db1, dw2, db2)``."""
    dt, f32 = x.dtype, torch.float32
    xf, do = x.to(f32), dout.to(dt).to(f32)
    h = torch.matmul(xf, w1.to(f32)) + b1.to(f32)
    cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    g = (h * cdf).to(dt).to(f32)
    dg = torch.matmul(do, w2.to(f32).t())
    dh = (dg * (cdf + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI)).to(dt).to(f32)
    return (torch.matmul(dh, w1.to(f32).t()).to(dt), torch.matmul(xf.t(), dh).to(w1.dtype),
            dh.sum(0).to(b1.dtype), torch.matmul(g.t(), do).to(w2.dtype), do.sum(0).to(b2.dtype))


def _mlp_block_bf16_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, ln_scale=None, ln_bias=None,
                          ln_eps=1e-6, layerscale=None, residual=False) -> torch.Tensor:
    """K11's function in plain PyTorch on ``(M, D_in)`` bf16: [LN, rounded
    to bf16 ->] fc1 -> GELU (f32) -> rounded to bf16 -> fc2 -> rounded to
    bf16 [-> * ls] [-> + x], each fold rounded to bf16."""
    h = x
    if ln_scale is not None:
        h = _layer_norm_f32(x, ln_scale, ln_bias, ln_eps).to(_BF16)
    out = _mlp_f32(h, w1, b1, w2, b2, _BF16).to(_BF16)
    if layerscale is not None:
        out = out * layerscale.to(_BF16)
    if residual:
        out = x + out
    return out


def _mlp_block_int8_plain(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                          b1: torch.Tensor, a1: float, w2: torch.Tensor, s2: torch.Tensor,
                          b2: torch.Tensor, a2: float, ln_scale=None, ln_bias=None, ln_eps=1e-6,
                          layerscale=None, residual=False) -> torch.Tensor:
    """K11 int8's function in plain PyTorch on ``(M, D_in)`` bf16: [LN
    (``_layer_norm_int8``), rounded to bf16 ->] quantize by ``1/a1`` ->
    int8 fc1 -> dequantize + bias -> GELU (f32, ``_gelu_as``) -> quantize
    by ``1/a2`` -> int8 fc2 -> dequantize + bias -> bf16 [-> * ls] [-> +
    x]; the integer products exact."""
    h = x
    if ln_scale is not None:
        h = _layer_norm_int8(x, ln_scale, ln_bias, ln_eps).to(_BF16)
    g = _gelu_as(int8_dense_f32(quantize_act(h, a1), w1, a1, s1, b1))
    out = int8_dense_f32(quantize_act(g, a2), w2, a2, s2, b2).to(_BF16)
    if layerscale is not None:
        out = out * layerscale.to(_BF16)
    if residual:
        out = x + out
    return out


def _check_mlp(name: str, x, w1, b1, w2, b2, *extra, wdt=None) -> torch.device:
    """Check an MLP kernel's operands, x ``(M, D_in)`` f32 or bf16, the
    weights in ``wdt`` (default x's dtype; int8 for K11 int8), the biases
    f32, and each ``(arg, tensor, dtype)`` of ``extra`` (``ln_scale``,
    ``ln_bias``, ``layerscale``, ``dout``, the int8 weights' scales): one
    CUDA device, contiguous, shapes that fit x's. Returns the device."""
    if x.dim() != 2 or 0 in x.shape or x.dtype not in (torch.float32, _BF16):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} is not a non-empty "
                         "(M, D_in) f32 or bf16")
    M, d_in = x.shape
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    f32 = torch.float32
    wdt = wdt or x.dtype
    checked = [("x", x, x.dtype), ("w1", w1, wdt), ("b1", b1, f32), ("w2", w2, wdt),
               ("b2", b2, f32), *extra]
    device = _check_cuda(name, checked)
    shapes = {"w1": (d_in, d_h), "b1": (d_h,), "w2": (d_h, d_out), "b2": (d_out,),
              "s1": (d_h,), "s2": (d_out,), "ln_scale": (d_in,), "ln_bias": (d_in,),
              "layerscale": (d_out,), "dout": (M, d_out)}
    for arg, t, _ in checked[1:]:
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)}, need {shapes[arg]}")
    return device


def _mlp_block_launch(name: str, x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, layerscale,
                      residual, quant=None) -> torch.Tensor:
    """Check a half-block's operands (x bf16) and launch K11
    (``vit_mlp_block_forward``) on the current stream, or with ``quant =
    (s1, a1, s2, a2)`` (int8 weights, their per-channel scales and the
    activation scales) K11 int8 (``vit_mlp_int8_forward``)."""
    if x.dtype != _BF16:
        raise ValueError(f"{name} takes bf16, got {x.dtype}")
    extra = []
    if ln_scale is not None:
        extra += [("ln_scale", ln_scale, torch.float32), ("ln_bias", ln_bias, torch.float32)]
    if layerscale is not None:
        extra.append(("layerscale", layerscale, x.dtype))
    if quant is not None:
        extra += [("s1", quant[0], torch.float32), ("s2", quant[2], torch.float32)]
    device = _check_mlp(name, x, w1, b1, w2, b2, *extra,
                        wdt=None if quant is None else torch.int8)
    M, d_in = x.shape
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    if residual and d_out != d_in:
        raise ValueError("residual=True requires D_out == D_in")
    if quant is not None and d_in % 4:
        raise ValueError(f"{name}: needs D_in a multiple of 4, got {d_in}")
    lib = _cuda.load_library("vit_mlp")
    if d_out > lib.vit_mlp_max_out():
        raise ValueError(f"{name}: D_out={d_out} is beyond the kernel's {lib.vit_mlp_max_out()}")
    out = torch.empty((M, d_out), dtype=x.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if quant is None:
            rc = lib.vit_mlp_block_forward(
                x.data_ptr(), _ptr(ln_scale), _ptr(ln_bias), float(ln_eps), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(layerscale), int(residual),
                out.data_ptr(), M, d_in, d_h, d_out, stream)
        else:
            # The reciprocals in double, rounded once to f32, as the JAX
            # kernel's Python-float ``1.0 / a`` is.
            s1, a1, s2, a2 = quant
            rc = lib.vit_mlp_int8_forward(
                x.data_ptr(), _ptr(ln_scale), _ptr(ln_bias), float(ln_eps), w1.data_ptr(),
                s1.data_ptr(), b1.data_ptr(), 1.0 / a1, float(a1), w2.data_ptr(), s2.data_ptr(),
                b2.data_ptr(), 1.0 / a2, float(a2), _ptr(layerscale), int(residual),
                out.data_ptr(), M, d_in, d_h, d_out, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.vit_mlp_error_string(rc).decode()}")
    return out


def mlp_cuda(x, w1, b1, w2, b2) -> torch.Tensor:
    """Launch K9 (``csrc/vit_mlp.cu`` ``vit_mlp_forward``, the tensor cores)
    on ``(M, D_in)`` x in f32 or bf16, the weights in x's dtype, the
    biases f32."""
    device = _check_mlp("mlp_cuda", x, w1, b1, w2, b2)
    M, d_in = x.shape
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    lib = _cuda.load_library("vit_mlp")
    out = torch.empty((M, d_out), dtype=x.dtype, device=device)
    with torch.cuda.device(device):
        rc = lib.vit_mlp_forward(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                 b2.data_ptr(), out.data_ptr(), M, d_in, d_h, d_out,
                                 int(x.dtype == _BF16),
                                 torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"mlp_cuda kernel launch failed: {lib.vit_mlp_error_string(rc).decode()}")
    mlp_cuda.launches += 1
    return out


mlp_cuda.launches = 0


def mlp_block_bf16_cuda(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, ln_eps=1e-6,
                        layerscale=None, residual=False) -> torch.Tensor:
    """Launch K11 (``csrc/vit_mlp.cu`` ``vit_mlp_block_forward``, FFMA, with
    its folds) on ``(M, D_in)`` bf16."""
    out = _mlp_block_launch("mlp_block_bf16_cuda", x, w1, b1, w2, b2, ln_scale, ln_bias,
                            ln_eps, layerscale, residual)
    mlp_block_bf16_cuda.launches += 1
    return out


mlp_block_bf16_cuda.launches = 0


def mlp_block_int8_cuda(x, w1, s1, b1, a1, w2, s2, b2, a2, ln_scale=None, ln_bias=None,
                        ln_eps=1e-6, layerscale=None, residual=False) -> torch.Tensor:
    """Launch K11 int8 (``csrc/vit_mlp.cu``) on ``(M, D_in)`` bf16 with int8
    weights ``w1 (D_in, D_h)``, ``w2 (D_h, D_out)``, their f32 per-channel
    scales and the Python-float activation scales ``a1``, ``a2``."""
    out = _mlp_block_launch("mlp_block_int8_cuda", x, w1, b1, w2, b2, ln_scale, ln_bias,
                            ln_eps, layerscale, residual, quant=(s1, a1, s2, a2))
    mlp_block_int8_cuda.launches += 1
    return out


mlp_block_int8_cuda.launches = 0


def mlp_bwd_cuda(x, w1, b1, w2, b2, dout):
    """Launch the K9 backward (``csrc/vit_mlp_bwd.cu``) on ``(M, D_in)`` x
    and ``(M, D_out)`` dO in x's dtype (weights too, biases f32). Scratch:
    g and dh ``(M, D_h)`` in x's dtype and the per-split weight-gradient
    partials in f32. Returns ``(dx, dw1, db1, dw2, db2)``."""
    device = _check_mlp("mlp_bwd_cuda", x, w1, b1, w2, b2, ("dout", dout, x.dtype))
    M, d_in = x.shape
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    f32 = torch.float32
    lib = _cuda.load_library("vit_mlp_bwd")
    bf16 = int(x.dtype == _BF16)
    with torch.cuda.device(device):
        splits = [lib.vit_mlp_bwd_splits(M, r, n, bf16) for r, n in ((d_in, d_h), (d_h, d_out))]
    if min(splits) <= 0:
        raise RuntimeError("vit_mlp_bwd_splits: the device could not be queried")
    dx, g, dh = (torch.empty((M, n), dtype=x.dtype, device=device) for n in (d_in, d_h, d_h))
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1, db2 = torch.empty_like(b1), torch.empty_like(b2)
    partials = torch.empty(splits[0] * (d_in + 1) * d_h + splits[1] * (d_h + 1) * d_out,
                           dtype=f32, device=device)
    with torch.cuda.device(device):
        rc = lib.vit_mlp_backward(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            g.data_ptr(), dh.data_ptr(), partials.data_ptr(), M, d_in, d_h, d_out, *splits,
            bf16, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vit_mlp_backward kernel launch failed: "
                           f"{lib.vit_mlp_bwd_error_string(rc).decode()}")
    mlp_bwd_cuda.launches += 1
    return dx, dw1, db1, dw2, db2


mlp_bwd_cuda.launches = 0


class _MLP(torch.autograd.Function):
    """K9 forward, K9 backward; saves ``(x, w1, b1, w2, b2)`` as
    ``_mlp_core_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return (_mlp_plain if x.device.type == "cpu" else mlp_cuda)(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x = ctx.saved_tensors[0]
        bwd = _mlp_bwd_plain if x.device.type == "cpu" else mlp_bwd_cuda
        return bwd(*ctx.saved_tensors, dout.to(x.dtype).contiguous())


def _flat(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(dtype).contiguous()


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``gelu(x w1 + b1) w2 + b2`` with the hidden activation kept on the
    chip (K9; differentiable, its backward recomputes h). ``x (..., D_in)``,
    ``w1 (D_in, D_h)``, ``w2 (D_h, D_out)`` as the JAX function takes them;
    the weights run in x's dtype, the biases in f32, and their gradients
    reach the caller's tensors through those casts."""
    dt = x.dtype
    out = _MLP.apply(_flat(x, dt), w1.to(dt).contiguous(),
                     b1.to(torch.float32).reshape(-1).contiguous(), w2.to(dt).contiguous(),
                     b2.to(torch.float32).reshape(-1).contiguous())
    return out.reshape(*x.shape[:-1], w2.shape[-1])


def fused_mlp_block_bf16(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """The float-serving MLP half-block (K11, inference only): [LN ->] fc1
    -> exact GELU -> fc2 [-> * layerscale] [-> + x], bf16 weights, f32
    products, bf16 out. Returns ``(..., D_out)`` bf16."""
    f32 = torch.float32

    args = (_flat(x, _BF16), w1.to(_BF16).contiguous(), _vec(b1, f32), w2.to(_BF16).contiguous(),
            _vec(b2, f32), _vec(ln_scale, f32), _vec(ln_bias, f32), float(ln_eps),
            _vec(layerscale, _BF16), bool(residual))
    out = (_mlp_block_bf16_plain if x.device.type == "cpu" else mlp_block_bf16_cuda)(*args)
    return out.reshape(*x.shape[:-1], w2.shape[-1])


def fused_mlp_int8(
    x: torch.Tensor, wq1: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor, act_scale1,
    wq2: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor, act_scale2, *,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """The quantized-serving MLP half-block (K11 int8, inference only): [LN
    ->] QDense(fc1) -> exact GELU -> QDense(fc2) [-> * layerscale] [-> +
    x], the hidden activation's codes kept on the chip. ``wq* (D_in,
    D_out)`` int8 with per-output-channel ``w*_scale``; ``act_scale*`` the
    calibrated per-tensor input scales (Python floats). Returns ``(...,
    D_out)`` bf16."""
    f32 = torch.float32

    args = (_flat(x, _BF16), wq1.to(torch.int8).contiguous(), _vec(w1_scale, f32), _vec(b1, f32),
            float(act_scale1), wq2.to(torch.int8).contiguous(), _vec(w2_scale, f32), _vec(b2, f32),
            float(act_scale2), _vec(ln_scale, f32), _vec(ln_bias, f32), float(ln_eps),
            _vec(layerscale, _BF16), bool(residual))
    out = (_mlp_block_int8_plain if x.device.type == "cpu" else mlp_block_int8_cuda)(*args)
    return out.reshape(*x.shape[:-1], wq2.shape[-1])
