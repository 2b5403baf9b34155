"""The int8 convolution of the quantized CNN featurizers.

Port of the ``s8 x s8 -> s32`` convolution of ``nwhead_tpu/models/quantize.py``
(``_qconv_apply_split``: ``jax.lax.conv_general_dilated(x8, wq, ...,
feature_group_count=groups, preferred_element_type=int32)``). On the TPU
XLA computed it outside any Pallas kernel, so this replaces no TPU kernel.
The layouts are JAX's: codes NHWC int8, weights HWIO ``(kh, kw, cin /
groups, cout)`` int8, the int32 sums NHWC.

``int8_conv2d`` takes CPU tensors through its plain version and CUDA
tensors through ``int8_conv2d_cuda``, with no fallback between them:

* plain (``_int8_conv2d_plain``, also the card's reference): ``F.conv2d``
  of the codes in float64, cast to int32. Every sum is an integer of at most
  ``127^2 * kh * kw * cin`` (< 2^27 at ResNet-50's widest 3x3, 4,608 terms),
  so float64 holds every partial sum exactly, in any order. Float32 would
  not: its mantissa stops at 2^24.
* CUDA: an NHWC im2col (``_im2col``: one strided copy, none for a 1x1
  stride-1 conv) and cuBLASLt's s8 GEMM with exact int32 sums
  (``torch._int_mm``, ``_gemm``). It takes more than 16 rows and inner and
  output widths that are multiples of 8: ``_gemm`` pads rows, columns and
  weights with zeros where a shape falls short, which adds nothing to a
  sum. Bound by bytes at the serving shapes (the im2col's copy and the
  int32 output) more than by the s8 tensor cores' 1,979 TOP/s.

A grouped conv (ResNeXt's 3x3: 32 groups of 4 channels at 32x4d, a GEMM of
K = 36 and N = 4 per group, which ``_int_mm`` refuses) goes to the GEMM as
one block-diagonal dense weight (``gemm_weight``): zeros outside each
group's block keep the sums exact, for ``groups`` times the grouped
multiply-adds in one launch, where the other exact choice, each group's K
and N padded to 8, is ``groups`` GEMMs a conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_MIN_ROWS = 17  # _int_mm on CUDA takes more than 16 rows
_ALIGN = 8  # ... and inner and output widths that are multiples of 8


def _out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def gemm_weight(wq: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """The CUDA route's GEMM operand of an HWIO int8 weight: ``(cout,
    kh * kw * cin)`` int8, contiguous (its transpose is the column-major B
    of ``torch._int_mm``), the columns in the im2col's ``(kh, kw, cin)``
    order. With ``groups > 1`` the block-diagonal dense weight: output
    channel ``g * opg + o`` sees only its group's input channels ``g * cpg
    + c``, the rest zeros."""
    kh, kw, cpg, cout = wq.shape
    if groups == 1:
        return wq.reshape(kh * kw * cpg, cout).t().contiguous()
    opg = cout // groups
    dense = wq.new_zeros((kh, kw, groups, cpg, groups, opg))
    g = torch.arange(groups, device=wq.device)
    # Two index arrays around a slice put the group dimension first.
    dense[:, :, g, :, g, :] = wq.reshape(kh, kw, cpg, groups, opg).permute(3, 0, 1, 2, 4)
    return dense.reshape(kh * kw * groups * cpg, cout).t().contiguous()


def _im2col(codes: torch.Tensor, kh: int, kw: int, stride: int,
            padding: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``(B, H, W, C)`` codes -> the ``(B * Ho * Wo, kh * kw * C)`` patch
    matrix, columns in ``(kh, kw, C)`` order, and ``(B, Ho, Wo)``. A view for
    a 1x1 stride-1 conv; otherwise one strided copy of the zero-padded
    codes."""
    B, H, W, C = codes.shape
    Ho, Wo = _out_size(H, kh, stride, padding), _out_size(W, kw, stride, padding)
    if kh == kw == 1 and stride == 1 and padding == 0:
        return codes.reshape(B * H * W, C), (B, Ho, Wo)
    if padding:
        codes = F.pad(codes, (0, 0, padding, padding, padding, padding))
    sB, sH, sW, sC = codes.stride()
    patches = codes.as_strided((B, Ho, Wo, kh, kw, C),
                               (sB, stride * sH, stride * sW, sH, sW, sC))
    return patches.reshape(B * Ho * Wo, kh * kw * C), (B, Ho, Wo)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def _gemm(a: torch.Tensor, w_gemm: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w_gemm (N, K)^T`` in exact int32 on cuBLASLt's s8 GEMM,
    rows, K and N zero-padded to what ``torch._int_mm`` takes."""
    M, K = a.shape
    N = w_gemm.shape[0]
    k_pad = -(-K // _ALIGN) * _ALIGN
    n_pad = -(-N // _ALIGN) * _ALIGN
    a = _pad_to(_pad_to(a, 1, k_pad), 0, _MIN_ROWS)
    b = _pad_to(_pad_to(w_gemm, 1, k_pad), 0, n_pad)
    out = torch._int_mm(a, b.t())
    return out[:M, :N]


def _int8_conv2d_plain(codes: torch.Tensor, wq: torch.Tensor, stride: int, padding: int,
                       groups: int = 1) -> torch.Tensor:
    """``int8_conv2d``'s function in plain PyTorch: the conv of the codes
    in float64 (exact: integer sums below 2^53), cast to int32, NHWC."""
    f64 = torch.float64
    y = F.conv2d(codes.permute(0, 3, 1, 2).to(f64), wq.permute(3, 2, 0, 1).to(f64),
                 stride=stride, padding=padding, groups=groups)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv2d_cuda(codes: torch.Tensor, wq: torch.Tensor, stride: int, padding: int,
                     groups: int = 1, w_gemm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA route: ``_im2col`` then ``_gemm`` on the current stream,
    ``(B, Ho, Wo, cout)`` int32. ``w_gemm`` is ``gemm_weight(wq, groups)``
    when the caller keeps one (``QConv`` does), else it is made here.
    Raises on CPU tensors and on anything else it does not take."""
    name = "int8_conv2d_cuda"
    if codes.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {codes.device}")
    if codes.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} and wq {tuple(wq.shape)} are not "
                         "NHWC and HWIO")
    kh, kw, cpg, cout = wq.shape
    if codes.shape[3] != cpg * groups or cout % groups:
        raise ValueError(f"{name}: {codes.shape[3]} input channels, wq {tuple(wq.shape)} and "
                         f"groups={groups} do not match")
    for arg, t in (("codes", codes), ("wq", wq)):
        if t.device != codes.device or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs contiguous int8 on {codes.device}, got "
                             f"{t.dtype} on {t.device}")
    if w_gemm is None:
        w_gemm = gemm_weight(wq, groups)
    K = kh * kw * cpg * groups
    if (w_gemm.shape != (cout, K) or w_gemm.dtype != torch.int8
            or w_gemm.device != codes.device or not w_gemm.is_contiguous()):
        raise ValueError(f"{name}: w_gemm needs contiguous int8 ({cout}, {K}) on "
                         f"{codes.device}, got {w_gemm.dtype} {tuple(w_gemm.shape)}")
    a, (B, Ho, Wo) = _im2col(codes, kh, kw, stride, padding)
    out = _gemm(a, w_gemm)
    int8_conv2d_cuda.launches += 1
    return out.reshape(B, Ho, Wo, cout)


int8_conv2d_cuda.launches = 0


def int8_conv2d(codes: torch.Tensor, wq: torch.Tensor, stride: int, padding: int,
                groups: int = 1, w_gemm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exact int32 convolution of int8 codes: ``codes (B, H, W, cin)``
    int8, ``wq (kh, kw, cin / groups, cout)`` int8, symmetric ``padding``;
    returns ``(B, Ho, Wo, cout)`` int32. CPU tensors take the plain
    version, CUDA tensors the CUDA route."""
    if codes.device.type == "cpu":
        return _int8_conv2d_plain(codes, wq, stride, padding, groups)
    return int8_conv2d_cuda(codes, wq, stride, padding, groups, w_gemm)
