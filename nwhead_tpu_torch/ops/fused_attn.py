"""Fused ViT attention: multi-head attention off the packed qkv (K7), its
backward (K8), the bf16 and int8 attention half-blocks (K10), and attention
over separate q, k, v (K12).

Port of ``nwhead_tpu/ops/pallas_attn.py``: ``fused_attention_qkv`` (forward
and backward), ``fused_attention_block_bf16`` (``quant=False``) and
``fused_attention_qkv_int8`` (``quant=True``). The kernels are CUDA C++ for
Hopper, built and loaded by ``ops/_cuda.py``:

* K7 ``vit_attention_forward`` (``csrc/vit_attn.cu``, TPU
  ``_attn_qkv_kernel``): per head ``softmax(q k^T * scale) v`` with the
  softmax in f32, f32 or bf16, its products on the tensor cores
  (``csrc/vit_mma.cuh``: bf16 on ``mma.sync``, f32 on 3xTF32);
* K8 ``vit_attention_backward`` (``csrc/vit_attn_bwd.cu``, TPU
  ``_attn_qkv_bwd_kernel`` and ``_attn_qkv_chunked_bwd_kernel``): the
  attention VJP from qkv and dO alone, probabilities recomputed, on the
  same tensor-core path;
* K10 ``vit_attention_block_bf16`` (``csrc/vit_attn.cu``, TPU
  ``_attn_int8_kernel`` with ``quant=False``): [LayerNorm ->] qkv ->
  attention -> proj [-> * LayerScale] [-> + x] in bf16 through device
  memory: the LayerNorm prologue that K11 shares (``csrc/vit_block.cuh``),
  the projections on a tensor-core GEMM (``proj_tc_kernel``, bf16
  ``mma.sync``) around K7's kernel;
* K10 int8 ``vit_attention_block_int8`` (``csrc/vit_attn.cu``, TPU
  ``_attn_int8_kernel`` with ``quant=True``): the same with both
  projections quantize -> int8 product -> dequantize + bias (per-tensor
  activation scales, per-channel weight scales; the prologue writes x's
  codes, the GEMM runs on s8 ``mma.sync`` with exact int32 sums), the
  attention in bf16 on FFMA with the scores summed in the plain version's
  order (the int8 codes of its output flip when the scores are summed in
  another order, and the int8 stack's limits hold only with that order);
  that stage keeps its scores in scratch between its two sweeps and writes
  its output's codes for the proj stage.
  ``vit_qkv_proj_int8`` runs its qkv stage alone (``qkv_proj_int8_cuda``,
  f32 out), which equals its plain version bit for bit;
* K12 ``fused_attention`` (TPU ``_attn_kernel``, ``pallas_attn.py:44``,
  inference only): ``softmax(q k^T * scale) v`` over ``(B, H, N, hd)`` q, k
  and v. On the card K7's kernel through ``vit_attention_forward_strided``,
  which reads q, k, v and writes the output by their batch, head and token
  strides: no copy. The TPU kernel's ``n_valid`` masks only its padding of
  N to 16 rows; K7 takes any N, so nothing is masked.

Each kernel has a wrapper that counts its launches (``.launches``) and a
plain PyTorch version of the same function (``_attention_qkv_plain``,
``_attention_qkv_bwd_plain``, ``_attention_plain``, ``_attention_block_bf16_plain``,
``_attention_block_int8_plain``, ``_qkv_proj_int8_plain``, whose integer
products are exact) that follows
the TPU kernel's single pass and its rounding points: probabilities
normalized in f32, then rounded to v's dtype before the PV product (and
before dV in the backward). ``fused_attention_qkv`` is a
``torch.autograd.Function`` that saves only qkv, as the JAX custom VJP
does. A CPU tensor goes to the plain versions, a CUDA tensor to the
kernels, with no fallback between them.

Left out as TPU workarounds that change no value: the VMEM budget tests
(``_select_k_chunk``, ``_bf16_attn_k_chunk``) and the ``_FLASH_CHUNK``
switch; the kernels take any N. The chunked TPU backward, which JAX runs
only past N of about 2,950, takes delta from the output built on rounded
probabilities; the port follows the single pass at every N.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nwhead_tpu_torch.ops import _cuda

_BF16 = torch.bfloat16
_HEAD_DIMS = (32, 64, 128)  # head widths the CUDA kernel is built for
# K10 int8 keeps its attention stage's f32 scores between its two sweeps in
# scratch of ceil(N / 64)^2 H 16 KB an image (157 MB at ViT-S/14's 64
# images of 257 tokens); above this many bytes it runs over batch slices.
_SCORES_BYTES = 256 << 20


def _layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The JAX kernels' LayerNorm in f32: biased variance, ``(x - mean) *
    rsqrt(var + eps) * scale + bias``."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)


def _layer_norm_int8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The int8 kernels' LayerNorm (``row_stats_f64`` in ``csrc/vit_common.cuh``):
    mean and variance summed in f64 and each of mean and ``1 / sqrt(var + eps)``
    rounded once to f32, so that the kernels, which sum in another order,
    get the same f32 values; then ``((x - mean) * rstd) * scale + bias`` in
    f32. The JAX kernels' f32 statistics differ from these by rounding."""
    f64 = torch.float64
    xf = x.to(torch.float32)
    mean = xf.to(f64).mean(-1, keepdim=True).to(torch.float32)
    d = xf - mean
    eps32 = float(torch.tensor(eps, dtype=torch.float32))  # the kernels take eps in f32
    rstd = (1.0 / torch.sqrt(torch.square(d.to(f64)).mean(-1, keepdim=True) + eps32))
    return d * rstd.to(torch.float32) * scale.to(torch.float32) + bias.to(torch.float32)


def quantize_act(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """Activation codes as the JAX int8 kernels compute them, in f32:
    ``clip(round(x * (1 / a)), -127, 127)``, a multiply by the reciprocal
    (rounded once to f32), rounding half to even. The reciprocal taken in
    double and rounded to f32 equals the f32 division ``f32(1) / f32(a)``
    that ``quantize.py``'s conv chain takes: for an f32 ``a``, ``1 / a`` lies
    either on an f32 midpoint (never: ``a`` would be a power of two) or at
    least 2^-49 of itself away from one, so the double's rounding never
    crosses it."""
    return torch.clamp(torch.round(x.to(torch.float32) * (1.0 / act_scale)), -127, 127)


def int8_dense_f32(codes: torch.Tensor, wq: torch.Tensor, act_scale: float,
                   w_scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``codes @ wq`` as the int32 product of the kernels (exact here: an f64
    product of integers below 2^53), then ``acc * (a * w_scale) + bias`` in
    f32, the product of scales first (``pallas_attn.py:419-426``)."""
    acc = torch.matmul(codes.to(torch.float64), wq.to(torch.float64)).to(torch.float32)
    return int8_epilogue(acc, act_scale, w_scale, bias)


def int8_epilogue(acc: torch.Tensor, act_scale: float, w_scale: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Dequantize an int8 layer's f32 sums: ``acc * (a * w_scale) + bias``
    in f32, the product of scales first, as the JAX int8 layers compute it
    (``pallas_attn.py:419-426``, ``quantize.py:156``)."""
    return acc * (act_scale * w_scale.to(torch.float32)) + bias.to(torch.float32)


def _heads_attention_f32(qkv: torch.Tensor, num_heads: int, scale: float,
                         p_dtype: torch.dtype) -> torch.Tensor:
    """``(B, N, 3D)`` qkv -> the f32 attention output ``(B, N, D)``: per
    head f32 scores ``q k^T * scale``, the softmax in f32, probabilities
    rounded to ``p_dtype``, the PV product summed in f32."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    hd = D // num_heads
    x = qkv.to(torch.float32).reshape(B, N, 3, num_heads, hd)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, N, hd)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    probs = (p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)).to(p_dtype).to(torch.float32)
    return torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(B, N, D)


def _attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K7's function in plain PyTorch: ``(B, N, 3D)`` -> ``(B, N, D)`` in
    qkv's dtype."""
    return _heads_attention_f32(qkv, num_heads, scale, qkv.dtype).to(qkv.dtype)


def _attention_qkv_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """K8's function in plain PyTorch, the TPU single pass
    (``_attn_qkv_bwd_kernel``) with its rounding points: ``(B, N, 3D)`` qkv
    and ``(B, N, D)`` dO (rounded to qkv's dtype) -> dqkv ``(B, N, 3D)`` in
    qkv's dtype. P in f32; ``P`` rounded to v's dtype for dV = P^T dO;
    dP = dO v^T in f32; delta = rowsum(dP * P) on the f32 P; dS = P (dP -
    delta) rounded to q's dtype; dQ = dS k * scale, dK = dS^T q * scale."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    hd = D // num_heads
    dt, f32 = qkv.dtype, torch.float32
    x = qkv.to(f32).reshape(B, N, 3, num_heads, hd)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, N, hd)
    do = dout.to(dt).to(f32).reshape(B, N, num_heads, hd).permute(0, 2, 1, 3)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).to(f32)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return torch.cat([g.to(dt).permute(0, 2, 1, 3).reshape(B, N, D) for g in (dq, dk, dv)], -1)


def _check_cuda(name: str, tensors) -> torch.device:
    """Every tensor contiguous on one CUDA device with its dtype; returns
    the device."""
    device = tensors[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    for arg, t, dt in tensors:
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs contiguous {dt} on {device}, "
                             f"got {t.dtype} on {t.device}")
    return device


def _qkv_shape(name: str, qkv: torch.Tensor, num_heads: int):
    """``(B, N, hd)`` of a ``(B, N, 3 H hd)`` f32 or bf16 qkv with hd a
    width the kernels are built for; raises otherwise."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads) or 0 in qkv.shape:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not (B, N, 3 H hd) for H={num_heads}")
    if qkv.dtype not in (torch.float32, _BF16):
        raise ValueError(f"{name}: qkv {qkv.dtype}: need f32 or bf16")
    hd = qkv.shape[2] // (3 * num_heads)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head width {hd}: the kernel is built for {_HEAD_DIMS}")
    return qkv.shape[0], qkv.shape[1], hd


def _launch(lib, fn: str, *args) -> None:
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: {lib.vit_attn_error_string(rc).decode()}")


def attention_qkv_cuda(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Launch K7 (``csrc/vit_attn.cu``) on the current stream: ``(B, N,
    3D)`` f32 or bf16 -> ``(B, N, D)``. Raises on anything the kernel does
    not take."""
    B, N, hd = _qkv_shape("attention_qkv_cuda", qkv, num_heads)
    device = _check_cuda("attention_qkv_cuda", [("qkv", qkv, qkv.dtype)])
    out = torch.empty((B, N, num_heads * hd), dtype=qkv.dtype, device=device)
    lib = _cuda.load_library("vit_attn")
    with torch.cuda.device(device):
        _launch(lib, "vit_attention_forward", qkv.data_ptr(), out.data_ptr(), B, N, num_heads,
                hd, float(scale), int(qkv.dtype == _BF16),
                torch.cuda.current_stream(device).cuda_stream)
    attention_qkv_cuda.launches += 1
    return out


attention_qkv_cuda.launches = 0


def _pack_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(B, H, N, hd)`` q, k, v -> K7's ``(B, N, 3 H hd)`` layout (the
    plain version's input), one copy."""
    B, H, N, hd = q.shape
    return torch.stack((q, k, v), dim=2).permute(0, 3, 2, 1, 4).reshape(B, N, 3 * H * hd)


def _unpack_heads(out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K7's ``(B, N, H hd)`` output -> ``(B, H, N, hd)``."""
    B, N, D = out.shape
    return out.reshape(B, N, num_heads, D // num_heads).permute(0, 2, 1, 3).contiguous()


def _check_qkv_split(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "need three (B, H, N, hd) arrays of one shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v need one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K12's function in plain PyTorch: K7's plain version on the packed
    q, k, v (f32 scores and softmax, probabilities rounded to v's dtype, the
    PV product summed in f32), ``(B, H, N, hd)`` in q's dtype."""
    _check_qkv_split("_attention_plain", q, k, v)
    return _unpack_heads(_attention_qkv_plain(_pack_qkv(q, k, v), q.shape[1], scale), q.shape[1])


def fused_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Launch K12, K7's kernel (``csrc/vit_attn.cu``) given q, k, v and the
    output by their strides: ``(B, H, N, hd)`` f32 or bf16, contiguous, hd
    in {32, 64, 128}; returns the same shape in q's dtype. Raises on
    anything the kernel does not take."""
    name = "fused_attention_cuda"
    _check_qkv_split(name, q, k, v)
    if 0 in q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} is empty")
    if q.dtype not in (torch.float32, _BF16):
        raise ValueError(f"{name}: q {q.dtype}: need f32 or bf16")
    B, H, N, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head width {hd}: the kernel is built for {_HEAD_DIMS}")
    device = _check_cuda(name, [("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype)])
    out = torch.empty_like(q)
    lib = _cuda.load_library("vit_attn")
    with torch.cuda.device(device):
        _launch(lib, "vit_attention_forward_strided", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, N, H, hd, *q.stride()[:3], *out.stride()[:3], float(scale),
                int(q.dtype == _BF16), torch.cuda.current_stream(device).cuda_stream)
    fused_attention_cuda.launches += 1
    return out


fused_attention_cuda.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention ``softmax(q k^T * scale) v`` (K12, the JAX package's
    ``fused_attention``): q, k, v ``(B, H, N, hd)``, the result the same
    shape in q's dtype; ``scale`` defaults to ``1 / sqrt(hd)``. Inference
    only: nothing is recorded for autograd."""
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with torch.no_grad():
        if q.device.type == "cpu":
            return _attention_plain(q, k, v, sc)
        return fused_attention_cuda(q, k, v, sc)


def attention_qkv_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                           scale: float) -> torch.Tensor:
    """Launch K8 (``csrc/vit_attn_bwd.cu``) on the current stream: ``(B, N,
    3D)`` qkv and ``(B, N, D)`` dO, both f32 or both bf16 -> dqkv ``(B, N,
    3D)`` in qkv's dtype. Per-row f32 statistics (the softmax's log-sum-exp
    in base 2, delta) go through a ``(2, B, H, N)`` scratch tensor. Raises on anything the kernel
    does not take."""
    B, N, hd = _qkv_shape("attention_qkv_bwd_cuda", qkv, num_heads)
    if tuple(dout.shape) != (B, N, num_heads * hd):
        raise ValueError(f"attention_qkv_bwd_cuda: dout {tuple(dout.shape)}: need "
                         f"{(B, N, num_heads * hd)}")
    device = _check_cuda("attention_qkv_bwd_cuda",
                         [("qkv", qkv, qkv.dtype), ("dout", dout, qkv.dtype)])
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((2, B, num_heads, N), dtype=torch.float32, device=device)
    lib = _cuda.load_library("vit_attn_bwd")
    with torch.cuda.device(device):
        rc = lib.vit_attention_backward(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N, num_heads,
            hd, float(scale), int(qkv.dtype == _BF16), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vit_attention_backward kernel launch failed: "
                           f"{lib.vit_attn_bwd_error_string(rc).decode()}")
    attention_qkv_bwd_cuda.launches += 1
    return dqkv


attention_qkv_bwd_cuda.launches = 0


class _AttentionQKV(torch.autograd.Function):
    """K7 forward, K8 backward; saves only qkv (``_attn_qkv_core``'s VJP)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        if qkv.device.type == "cpu":
            return _attention_qkv_plain(qkv, num_heads, scale)
        return attention_qkv_cuda(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()
        bwd = _attention_qkv_bwd_plain if qkv.device.type == "cpu" else attention_qkv_bwd_cuda
        return bwd(qkv, dout, ctx.num_heads, ctx.scale), None, None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention straight off the qkv projection (K7; differentiable, its
    backward is K8, which recomputes the probabilities from qkv).

    ``qkv``: ``(B, N, 3, H, hd)`` as reshaped from the fused qkv Dense
    output (or already flat ``(B, N, 3 H hd)``). Returns ``(B, N, H hd)``
    in qkv's dtype."""
    if qkv.dim() == 5:
        B, N, three, H, hd = qkv.shape
        if three != 3 or H != num_heads:
            raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, N, 3, {num_heads}, hd)")
        qkv = qkv.reshape(B, N, 3 * H * hd)
    hd = qkv.shape[-1] // (3 * num_heads)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    return _AttentionQKV.apply(qkv.contiguous(), num_heads, sc)


def _attention_block_bf16_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
    b_proj: torch.Tensor, num_heads: int, scale: float, ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor], ln_eps: float, layerscale: Optional[torch.Tensor],
    residual: bool,
) -> torch.Tensor:
    """K10's function in plain PyTorch, with the TPU kernel's bf16 rounding
    points: LN output, qkv, probabilities, the attention output before
    proj, proj's output before ``* ls`` and each of ``* ls`` and ``+ x``."""
    B, N, D = x.shape
    h = x.to(torch.float32)
    if ln_scale is not None:
        h = _layer_norm_f32(h, ln_scale, ln_bias, ln_eps)
    h = h.to(_BF16).to(torch.float32)
    qkv = (torch.matmul(h, w_qkv.to(torch.float32)) + b_qkv.to(torch.float32)).to(_BF16)
    att = _heads_attention_f32(qkv, num_heads, scale, _BF16).to(_BF16).to(torch.float32)
    out = (torch.matmul(att, w_proj.to(torch.float32)) + b_proj.to(torch.float32)).to(_BF16)
    if layerscale is not None:
        out = out * layerscale.to(_BF16)
    if residual:
        out = x + out
    return out


def _qkv_proj_int8_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    a_qkv: float, ln_scale: Optional[torch.Tensor], ln_bias: Optional[torch.Tensor],
    ln_eps: float,
) -> torch.Tensor:
    """K10 int8's qkv stage in plain PyTorch: [LN (``_layer_norm_int8``),
    rounded to bf16 ->] quantize by ``1/a_qkv`` -> int8 product ->
    dequantize + bias, f32 ``(..., n_out)`` (before its rounding to bf16)."""
    h = x.to(torch.float32)
    if ln_scale is not None:
        h = _layer_norm_int8(h, ln_scale, ln_bias, ln_eps).to(_BF16).to(torch.float32)
    return int8_dense_f32(quantize_act(h, a_qkv), w_qkv, a_qkv, s_qkv, b_qkv)


def _attention_block_int8_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    a_qkv: float, w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    a_proj: float, num_heads: int, scale: float, ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor], ln_eps: float, layerscale: Optional[torch.Tensor],
    residual: bool,
) -> torch.Tensor:
    """K10 int8's function in plain PyTorch: the qkv stage
    (``_qkv_proj_int8_plain``) -> bf16 -> the bf16 attention (K7's) -> the
    output rounded to bf16 -> quantize by ``1/a_proj`` -> int8 proj product
    -> dequantize + bias -> bf16 [-> * ls] [-> + x], as
    ``_attn_int8_kernel`` rounds them."""
    qkv = _qkv_proj_int8_plain(x, w_qkv, s_qkv, b_qkv, a_qkv, ln_scale, ln_bias,
                               ln_eps).to(_BF16)
    att = _heads_attention_f32(qkv, num_heads, scale, _BF16).to(_BF16)
    out = int8_dense_f32(quantize_act(att, a_proj), w_proj, a_proj, s_proj, b_proj).to(_BF16)
    if layerscale is not None:
        out = out * layerscale.to(_BF16)
    if residual:
        out = x + out
    return out


def _check_block(name: str, x: torch.Tensor, num_heads: int, wdt: torch.dtype, w_qkv, b_qkv,
                 w_proj, b_proj, ln_scale, ln_bias, layerscale, scales=()) -> torch.device:
    """Check an attention half-block's operands: x ``(B, N, D)`` bf16 with a
    head width the kernel takes, weights ``wdt``, the rest f32 but the bf16
    LayerScale, each of its shape. Returns the device."""
    if x.dim() != 3 or x.shape[2] % num_heads or 0 in x.shape:
        raise ValueError(f"x {tuple(x.shape)} is not (B, N, D) with D a multiple of {num_heads}")
    D = x.shape[2]
    if D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head width {D // num_heads}: the kernel is built for {_HEAD_DIMS}")
    f32 = torch.float32
    checked = [("x", x, _BF16), ("w_qkv", w_qkv, wdt), ("b_qkv", b_qkv, f32),
               ("w_proj", w_proj, wdt), ("b_proj", b_proj, f32), *scales]
    if ln_scale is not None:
        checked += [("ln_scale", ln_scale, f32), ("ln_bias", ln_bias, f32)]
    if layerscale is not None:
        checked.append(("layerscale", layerscale, _BF16))
    device = _check_cuda(name, checked)
    shapes = {"w_qkv": (D, 3 * D), "b_qkv": (3 * D,), "w_proj": (D, D), "b_proj": (D,),
              "s_qkv": (3 * D,), "s_proj": (D,), "ln_scale": (D,), "ln_bias": (D,),
              "layerscale": (D,)}
    for arg, t, _ in checked[1:]:
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{arg} {tuple(t.shape)}: need {shapes[arg]} for D={D}")
    return device


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A per-channel operand flattened, contiguous, in ``dtype`` (None stays)."""
    return None if t is None else t.to(dtype).reshape(-1).contiguous()


def attention_block_bf16_cuda(
    x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
    b_proj: torch.Tensor, num_heads: int, scale: float, ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor], ln_eps: float, layerscale: Optional[torch.Tensor],
    residual: bool,
) -> torch.Tensor:
    """Launch K10 (``csrc/vit_attn.cu``) on the current stream: [the
    LayerNorm prologue ->] the qkv GEMM -> K7 -> the proj GEMM, through bf16
    scratch ``qkv (B, N, 3D)`` and ``att (B, N, D)`` (which holds LN(x)
    until the attention writes it). Takes the operands in the dtypes
    ``fused_attention_block_bf16`` casts them to; raises on anything
    else."""
    device = _check_block("attention_block_bf16_cuda", x, num_heads, _BF16, w_qkv, b_qkv,
                          w_proj, b_proj, ln_scale, ln_bias, layerscale)
    B, N, D = x.shape
    qkv = torch.empty((B, N, 3 * D), dtype=_BF16, device=device)
    att = torch.empty((B, N, D), dtype=_BF16, device=device)
    out = torch.empty_like(x)
    lib = _cuda.load_library("vit_attn")
    with torch.cuda.device(device):
        _launch(lib, "vit_attention_block_bf16", x.data_ptr(), _ptr(ln_scale), _ptr(ln_bias),
                float(ln_eps), w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
                b_proj.data_ptr(), _ptr(layerscale), int(residual), qkv.data_ptr(),
                att.data_ptr(), out.data_ptr(), B, N, D, num_heads, float(scale),
                torch.cuda.current_stream(device).cuda_stream)
    attention_block_bf16_cuda.launches += 1
    return out


attention_block_bf16_cuda.launches = 0


def attention_block_int8_cuda(
    x: torch.Tensor, w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    a_qkv: float, w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    a_proj: float, num_heads: int, scale: float, ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor], ln_eps: float, layerscale: Optional[torch.Tensor],
    residual: bool,
) -> torch.Tensor:
    """Launch K10 int8 (``csrc/vit_attn.cu``) on the current stream: x's
    codes -> the s8 qkv GEMM -> the FFMA attention, which writes its
    output's codes -> the s8 proj GEMM, through scratch ``qkv (B, N, 3D)``
    bf16, ``codes (B, N, D)`` int8 (x's codes, then the attention
    output's) and the attention's f32 scores (``_SCORES_BYTES`` at most, or
    one image's). Takes the operands in the dtypes ``fused_attention_qkv_int8``
    casts them to (int8 weights ``(D, 3D)``, ``(D, D)``, f32 per-channel
    scales and biases); raises on anything else."""
    f32 = torch.float32
    device = _check_block("attention_block_int8_cuda", x, num_heads, torch.int8, w_qkv, b_qkv,
                          w_proj, b_proj, ln_scale, ln_bias, layerscale,
                          [("s_qkv", s_qkv, f32), ("s_proj", s_proj, f32)])
    B, N, D = x.shape
    if D % 4:
        raise ValueError(f"attention_block_int8_cuda: D={D} is not a multiple of 4")
    qkv = torch.empty((B, N, 3 * D), dtype=_BF16, device=device)
    codes = torch.empty((B, N, D), dtype=torch.int8, device=device)
    lib = _cuda.load_library("vit_attn")
    per_image = lib.vit_seq_scores_bytes(1, N, num_heads)
    images = max(1, min(B, _SCORES_BYTES // per_image))
    scores = torch.empty(images * per_image // 4, dtype=torch.float32, device=device)
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        # The reciprocals in double, rounded once to f32, as the JAX kernel's
        # Python-float ``1.0 / a`` is.
        _launch(lib, "vit_attention_block_int8", x.data_ptr(), _ptr(ln_scale), _ptr(ln_bias),
                float(ln_eps), w_qkv.data_ptr(), s_qkv.data_ptr(), b_qkv.data_ptr(),
                1.0 / a_qkv, float(a_qkv), w_proj.data_ptr(), s_proj.data_ptr(),
                b_proj.data_ptr(), 1.0 / a_proj, float(a_proj), _ptr(layerscale),
                int(residual), qkv.data_ptr(), codes.data_ptr(), scores.data_ptr(), images,
                out.data_ptr(), B, N, D, num_heads, float(scale),
                torch.cuda.current_stream(device).cuda_stream)
    attention_block_int8_cuda.launches += 1
    return out


attention_block_int8_cuda.launches = 0


def qkv_proj_int8_cuda(
    x: torch.Tensor, w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    a_qkv: float, ln_scale: Optional[torch.Tensor], ln_bias: Optional[torch.Tensor],
    ln_eps: float,
) -> torch.Tensor:
    """Launch K10 int8's qkv stage alone (``csrc/vit_attn.cu``
    ``vit_qkv_proj_int8``: the codes' prologue, the s8 GEMM, the
    dequantized sum + bias) on the current stream: x ``(..., D)`` bf16, D a
    multiple of 4, ``w_qkv (D, n_out)`` int8, f32 ``s_qkv`` and ``b_qkv
    (n_out,)``; returns f32 ``(..., n_out)``, ``_qkv_proj_int8_plain``'s
    values bit for bit. Raises on anything else."""
    name = "qkv_proj_int8_cuda"
    if x.dim() < 1 or 0 in x.shape or w_qkv.dim() != 2 or w_qkv.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w_qkv {tuple(w_qkv.shape)} are not "
                         "(..., D) and (D, n_out)")
    D, n_out = w_qkv.shape
    if D % 4:
        raise ValueError(f"{name}: D={D} is not a multiple of 4")
    f32 = torch.float32
    checked = [("x", x, _BF16), ("w_qkv", w_qkv, torch.int8), ("s_qkv", s_qkv, f32),
               ("b_qkv", b_qkv, f32)]
    if ln_scale is not None:
        checked += [("ln_scale", ln_scale, f32), ("ln_bias", ln_bias, f32)]
    device = _check_cuda(name, checked)
    for arg, t, n in (("s_qkv", s_qkv, n_out), ("b_qkv", b_qkv, n_out), ("ln_scale", ln_scale, D),
                      ("ln_bias", ln_bias, D)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)}: need {(n,)}")
    M = x.numel() // D
    codes = torch.empty((M, D), dtype=torch.int8, device=device)
    out = torch.empty((*x.shape[:-1], n_out), dtype=f32, device=device)
    lib = _cuda.load_library("vit_attn")
    with torch.cuda.device(device):
        _launch(lib, "vit_qkv_proj_int8", x.data_ptr(), _ptr(ln_scale), _ptr(ln_bias),
                float(ln_eps), w_qkv.data_ptr(), s_qkv.data_ptr(), b_qkv.data_ptr(), 1.0 / a_qkv,
                float(a_qkv), codes.data_ptr(), out.data_ptr(), M, D, n_out,
                torch.cuda.current_stream(device).cuda_stream)
    qkv_proj_int8_cuda.launches += 1
    return out


qkv_proj_int8_cuda.launches = 0


def fused_attention_block_bf16(
    x: torch.Tensor, w_qkv: torch.Tensor, qkv_bias: torch.Tensor, w_proj: torch.Tensor,
    proj_bias: torch.Tensor, num_heads: int, *, scale: Optional[float] = None,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-6, layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """The float-serving attention half-block (K10, inference only):
    ``[LN ->] x w_qkv + b -> attention -> @ w_proj + b [-> * layerscale]
    [-> + x]`` with bf16 weights, f32 products and softmax, bf16 out.
    ``x (B, N, D)``; ``w_qkv (D, 3D)``, ``w_proj (D, D)`` as the JAX
    function takes them. Returns ``(B, N, D)`` bf16."""
    D = x.shape[-1]
    f32 = torch.float32

    args = (x.to(_BF16).contiguous(), w_qkv.to(_BF16).contiguous(), _vec(qkv_bias, f32),
            w_proj.to(_BF16).contiguous(), _vec(proj_bias, f32), num_heads,
            float(scale) if scale is not None else 1.0 / math.sqrt(D // num_heads),
            _vec(ln_scale, f32), _vec(ln_bias, f32), float(ln_eps), _vec(layerscale, _BF16),
            bool(residual))
    if x.device.type == "cpu":
        return _attention_block_bf16_plain(*args)
    return attention_block_bf16_cuda(*args)


def fused_attention_qkv_int8(
    x: torch.Tensor, wq_qkv: torch.Tensor, qkv_w_scale: torch.Tensor, qkv_bias: torch.Tensor,
    qkv_act_scale, wq_proj: torch.Tensor, proj_w_scale: torch.Tensor,
    proj_bias: torch.Tensor, proj_act_scale, num_heads: int, *,
    scale: Optional[float] = None, ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None, ln_eps: float = 1e-6,
    layerscale: Optional[torch.Tensor] = None, residual: bool = False,
) -> torch.Tensor:
    """The quantized-serving attention half-block (K10 int8, inference
    only): ``[LN ->] QDense(qkv) -> attention -> QDense(proj) [-> *
    layerscale] [-> + x]``. ``x (B, N, D)``; ``wq_* (D_in, D_out)`` int8 with
    per-output-channel ``*_w_scale``; ``*_act_scale`` the calibrated
    per-tensor input scales (Python floats). Returns ``(B, N, D)`` bf16."""
    D = x.shape[-1]
    f32 = torch.float32

    args = (x.to(_BF16).contiguous(), wq_qkv.to(torch.int8).contiguous(), _vec(qkv_w_scale, f32),
            _vec(qkv_bias, f32), float(qkv_act_scale), wq_proj.to(torch.int8).contiguous(),
            _vec(proj_w_scale, f32), _vec(proj_bias, f32), float(proj_act_scale), num_heads,
            float(scale) if scale is not None else 1.0 / math.sqrt(D // num_heads),
            _vec(ln_scale, f32), _vec(ln_bias, f32), float(ln_eps), _vec(layerscale, _BF16),
            bool(residual))
    if x.device.type == "cpu":
        return _attention_block_int8_plain(*args)
    return attention_block_int8_cuda(*args)
