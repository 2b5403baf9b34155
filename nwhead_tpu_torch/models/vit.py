"""Vision Transformer backbones (DINOv2-style), headless, in PyTorch.

Port of ``nwhead_tpu/models/vit.py``: ``VisionTransformer``, ``Block``,
``Attention``, ``MlpBlock`` and ``vit_s14`` (the reference's
``dinov2_vits14``, feature width 384), ``vit_b14``, ``vit_l14`` and
``vit_s16``. ``forward`` takes NHWC float images, as the JAX model does, and
returns the final-LayerNorm CLS token ``(B, embed_dim)`` in f32.

* patch embedding: a convolution with stride = patch (``F.conv2d``);
* CLS token and learned position embeddings, the patch grid's resampled
  bicubically to the input's grid (``_interpolate_pos_embed``);
* pre-norm blocks, LayerNorm eps 1e-6, LayerScale (init 1e-5 as DINOv2).

``attn_impl``/``mlp_impl``: ``'xla'`` (plain PyTorch, the JAX default's
name) or ``'fused'`` (``ops/fused_attn.py`` and ``ops/fused_mlp.py``: K7
and K9 forward, K8 and the K9 backward, so a fused ViT trains too). The
qkv, proj and patch-embedding products stay ``F.linear`` and
``F.conv2d`` on both, as the JAX model left them to XLA. ``dtype``: None
(f32) or ``torch.bfloat16``, which computes in bf16 from f32 parameters as
flax's ``dtype`` does (LayerNorm statistics and the softmax in f32).

Parameters are initialized as flax initializes them (truncated normal 0.02
for the CLS token and position embeddings, LeCun-normal Dense and conv
kernels, zero biases), drawn from ``generator``; the JAX package's weights
carry over through ``models/convert.py:jax_to_torch_vit``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nwhead_tpu_torch.ops.fused_attn import fused_attention_qkv
from nwhead_tpu_torch.ops.fused_mlp import fused_mlp

LN_EPS = 1e-6
_IMPLS = ("xla", "fused")


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """A flax ``Dense`` with ``dtype``: input and kernel in ``dtype``."""
    return F.linear(_cast(x, dtype), _cast(layer.weight, dtype), _cast(layer.bias, dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax's ``LayerNorm`` with ``dtype``: statistics and affine in f32,
    the result in ``dtype`` (or x's dtype)."""
    out_dtype = dtype or x.dtype
    y = F.layer_norm(x.to(torch.float32), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(out_dtype)


def _check_impl(name: str, impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"{name}={impl!r}: use one of {_IMPLS}")


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dtype=None,
                 mlp_impl: str = "xla") -> None:
        super().__init__()
        _check_impl("mlp_impl", mlp_impl)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.dtype, self.mlp_impl = dtype, mlp_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_impl == "fused":
            # K9 takes the kernels as (in, out), as flax stores them.
            return fused_mlp(_cast(x, self.dtype), self.fc1.weight.t(), self.fc1.bias,
                             self.fc2.weight.t(), self.fc2.bias)
        h = F.gelu(_linear(x, self.fc1, self.dtype), approximate="none")
        return _linear(h, self.fc2, self.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=None, attn_impl: str = "xla") -> None:
        super().__init__()
        _check_impl("attn_impl", attn_impl)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.dim, self.num_heads, self.dtype, self.attn_impl = dim, num_heads, dtype, attn_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = _linear(x, self.qkv, self.dtype).reshape(B, N, 3, self.num_heads, hd)
        if self.attn_impl == "fused":
            out = fused_attention_qkv(qkv, self.num_heads)
        else:
            q, k, v = qkv.unbind(2)  # (B, N, H, hd)
            attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
            attn = torch.softmax(attn.to(torch.float32), dim=-1)
            if self.dtype is not None:
                attn = attn.to(self.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v).reshape(B, N, self.dim)
        return _linear(out, self.proj, self.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale_init: Optional[float] = 1e-5, dtype=None, attn_impl: str = "xla",
                 mlp_impl: str = "xla") -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim, dtype, mlp_impl)
        self.ls1_gamma = self.ls2_gamma = None
        if layerscale_init is not None:
            self.ls1_gamma = nn.Parameter(torch.full((dim,), float(layerscale_init)))
            self.ls2_gamma = nn.Parameter(torch.full((dim,), float(layerscale_init)))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(_layer_norm(x, self.norm1, self.dtype))
        if self.ls1_gamma is not None:
            h = h * self.ls1_gamma  # f32 gamma: a bf16 stream turns f32 here, as in flax
        x = x + h
        h = self.mlp(_layer_norm(x, self.norm2, self.dtype))
        if self.ls2_gamma is not None:
            h = h * self.ls2_gamma
        return x + h


def _interpolate_pos_embed(pos: torch.Tensor, n_patches: int, h: int, w: int) -> torch.Tensor:
    """Resample the ``(1, g*g, D)`` patch position embeddings to an (h, w)
    grid (DINOv2's ``interpolate_pos_encoding``), as ``jax.image.resize(...,
    "bicubic")`` does: Keys cubic (a = -0.5), half-pixel centres, and a
    widened kernel when shrinking, which is ``antialias=True`` here."""
    n_orig = pos.shape[1]
    if n_orig == n_patches:
        return pos
    g = int(math.sqrt(n_orig))
    dim = pos.shape[-1]
    grid = pos.reshape(1, g, g, dim).permute(0, 3, 1, 2).to(torch.float32)
    grid = F.interpolate(grid, size=(h, w), mode="bicubic", align_corners=False, antialias=True)
    return grid.permute(0, 2, 3, 1).reshape(1, h * w, dim).to(pos.dtype)


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> None:
    """flax's ``truncated_normal(std)``: a normal of ``std`` cut at two
    standard deviations."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class VisionTransformer(nn.Module):
    """Headless ViT: NHWC images -> the final-norm CLS token ``(B, D)``, f32."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0,
                 layerscale_init: Optional[float] = 1e-5, img_size: int = 518, dtype=None,
                 attn_impl: str = "xla", mlp_impl: str = "xla", *,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: use None (f32) or torch.bfloat16")
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.num_heads, self.img_size, self.dtype = num_heads, img_size, dtype
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        n_pos = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, layerscale_init, dtype, attn_impl, mlp_impl)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.reset_parameters(generator)

    @property
    def feat_dim(self) -> int:
        return self.embed_dim

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: LeCun-normal kernels (truncated normal of
        variance 1/fan_in), zero biases, LayerNorm 1/0, CLS and position
        embeddings truncated normal 0.02. LayerScale keeps its init."""
        _trunc_normal_(self.cls_token, 0.02, generator)
        _trunc_normal_(self.pos_embed, 0.02, generator)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                # 0.8796 is the std of a unit normal cut at +-2.
                _trunc_normal_(m.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = F.conv2d(x.permute(0, 3, 1, 2), _cast(self.patch_embed.weight, self.dtype),
                     _cast(self.patch_embed.bias, self.dtype), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, gh gw, D)
        pos = self.pos_embed
        patch_pos = _interpolate_pos_embed(pos[:, 1:], gh * gw, gh, gw)
        x = x + patch_pos.to(x.dtype)
        cls_tok = (self.cls_token + pos[:, :1]).to(x.dtype)
        x = torch.cat([cls_tok.expand(B, 1, self.embed_dim), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = _layer_norm(x, self.norm, self.dtype)
        return x[:, 0].to(torch.float32)


def vit_s14(**kw) -> VisionTransformer:
    """DINOv2 ViT-S/14 (feature width 384, the reference's ``dinov2_vits14``)."""
    return VisionTransformer(patch_size=14, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_b14(**kw) -> VisionTransformer:
    return VisionTransformer(patch_size=14, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_l14(**kw) -> VisionTransformer:
    return VisionTransformer(patch_size=14, embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_s16(**kw) -> VisionTransformer:
    return VisionTransformer(patch_size=16, embed_dim=384, depth=12, num_heads=6, img_size=224,
                             **kw)
