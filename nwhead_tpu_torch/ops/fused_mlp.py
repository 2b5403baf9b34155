"""Fused transformer MLP: the forward of ``fc1 -> exact GELU -> fc2`` (K9)
and the bf16 MLP half-block (K11).

Port of ``nwhead_tpu/ops/pallas_mlp.py``: ``fused_mlp`` (forward only) and
``fused_mlp_block_bf16`` (``quant=False``). Both run one CUDA C++ kernel
for Hopper, ``csrc/vit_mlp.cu`` ``vit_mlp_forward`` (TPU ``_mlp_kernel``
and ``_mlp_int8_kernel``), in which the hidden activation never leaves the
chip; K11 adds the optional LayerNorm before fc1 and the LayerScale and
residual after fc2.

Each kernel has a wrapper that counts its launches (``.launches``) and a
plain PyTorch version (``_mlp_plain``, ``_mlp_block_bf16_plain``) with the
TPU kernel's rounding points. The exact GELU uses ``torch.erf`` here and
``erff`` in the kernel; the JAX kernels use an approximation of erf
(Abramowitz & Stegun 7.1.26, absolute error 1.5e-7), which the tests'
tolerances cover. A CPU tensor goes to the plain version, a CUDA tensor to
the kernel, with no fallback between them. The backward of K9 is not
ported yet, so ``fused_mlp`` refuses inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nwhead_tpu_torch.ops import _cuda
from nwhead_tpu_torch.ops.fused_attn import _check_cuda, _layer_norm_f32

_BF16 = torch.bfloat16


def _gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


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


def _mlp_launch(name: str, x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, layerscale,
                residual) -> torch.Tensor:
    """Check the operands and launch ``vit_mlp_forward`` on the current
    stream."""
    if x.dim() != 2 or 0 in x.shape or x.dtype not in (torch.float32, _BF16):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} is not a non-empty "
                         "(M, D_in) f32 or bf16")
    M, d_in = x.shape
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    f32 = torch.float32
    checked = [("x", x, x.dtype), ("w1", w1, x.dtype), ("b1", b1, f32), ("w2", w2, x.dtype),
               ("b2", b2, f32)]
    if ln_scale is not None:
        checked += [("ln_scale", ln_scale, f32), ("ln_bias", ln_bias, f32)]
    if layerscale is not None:
        checked.append(("layerscale", layerscale, x.dtype))
    device = _check_cuda(name, checked)
    shapes = {"w1": (d_in, d_h), "b1": (d_h,), "w2": (d_h, d_out), "b2": (d_out,),
              "ln_scale": (d_in,), "ln_bias": (d_in,), "layerscale": (d_out,)}
    for arg, t, _ in checked[1:]:
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)}, need {shapes[arg]}")
    if residual and d_out != d_in:
        raise ValueError("residual=True requires D_out == D_in")
    lib = _cuda.load_library("vit_mlp")
    if d_out > lib.vit_mlp_max_out():
        raise ValueError(f"{name}: D_out={d_out} is beyond the kernel's {lib.vit_mlp_max_out()}")
    out = torch.empty((M, d_out), dtype=x.dtype, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        rc = lib.vit_mlp_forward(
            x.data_ptr(), ptr(ln_scale), ptr(ln_bias), float(ln_eps), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ptr(layerscale), int(residual),
            out.data_ptr(), M, d_in, d_h, d_out, int(x.dtype == _BF16),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vit_mlp_forward kernel launch failed: "
                           f"{lib.vit_mlp_error_string(rc).decode()}")
    return out


def mlp_cuda(x, w1, b1, w2, b2) -> torch.Tensor:
    """Launch K9 (``csrc/vit_mlp.cu``, no folds) on ``(M, D_in)``."""
    out = _mlp_launch("mlp_cuda", x, w1, b1, w2, b2, None, None, 0.0, None, False)
    mlp_cuda.launches += 1
    return out


mlp_cuda.launches = 0


def mlp_block_bf16_cuda(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, ln_eps=1e-6,
                        layerscale=None, residual=False) -> torch.Tensor:
    """Launch K11 (``csrc/vit_mlp.cu`` in bf16, with its folds) on ``(M,
    D_in)`` bf16."""
    if x.dtype != _BF16:
        raise ValueError(f"mlp_block_bf16_cuda takes bf16, got {x.dtype}")
    out = _mlp_launch("mlp_block_bf16_cuda", x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps,
                      layerscale, residual)
    mlp_block_bf16_cuda.launches += 1
    return out


mlp_block_bf16_cuda.launches = 0


def _flat(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(dtype).contiguous()


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``gelu(x w1 + b1) w2 + b2`` with the hidden activation kept on the
    chip (K9, forward only). ``x (..., D_in)``, ``w1 (D_in, D_h)``, ``w2
    (D_h, D_out)`` as the JAX function takes them; the weights run in x's
    dtype, the biases in f32. Raises ``NotImplementedError`` where autograd
    would record it (grad enabled, an input that requires grad): K9's
    backward is not ported yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "fused_mlp has no backward yet: the K9 backward (_mlp_bwd_kernel) is not "
            "ported (ROADMAP.md queue 2); use mlp_impl='xla' to differentiate")
    dt = x.dtype
    args = (_flat(x, dt), w1.to(dt).contiguous(), b1.to(torch.float32).reshape(-1).contiguous(),
            w2.to(dt).contiguous(), b2.to(torch.float32).reshape(-1).contiguous())
    out = (_mlp_plain if x.device.type == "cpu" else mlp_cuda)(*args)
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

    def vec(t, dt):
        return None if t is None else t.to(dt).reshape(-1).contiguous()

    args = (_flat(x, _BF16), w1.to(_BF16).contiguous(), vec(b1, f32), w2.to(_BF16).contiguous(),
            vec(b2, f32), vec(ln_scale, f32), vec(ln_bias, f32), float(ln_eps),
            vec(layerscale, _BF16), bool(residual))
    out = (_mlp_block_bf16_plain if x.device.type == "cpu" else mlp_block_bf16_cuda)(*args)
    return out.reshape(*x.shape[:-1], w2.shape[-1])
