"""The bf16 fused-serving ViT: every block half one kernel.

Port of ``nwhead_tpu/models/serving_vit.py``: ``ServingViT`` and
``fuse_vit_serving``. Built from a ``VisionTransformer``'s weights with no
calibration, it computes the model's eval forward in bf16 with each block
as two kernels:

* K10 ``fused_attention_block_bf16`` (``ops/fused_attn.py``): LayerNorm,
  qkv, attention, proj, LayerScale and the residual add;
* K11 ``fused_mlp_block_bf16`` (``ops/fused_mlp.py``): LayerNorm, fc1,
  exact GELU, fc2, LayerScale and the residual add.

Around them, as the JAX graph does: the patch embedding as a bf16
convolution plus a bf16 bias, the bf16 position-embedding and CLS adds, and
the final LayerNorm (``QLayerNorm``: f32 statistics, bf16 out); the CLS
feature comes back in f32. The JAX graph falls back to K7 when K10 does
not fit in VMEM; K10 here takes any N, so there is no such branch.
Serving only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nwhead_tpu_torch.models.vit import LN_EPS, VisionTransformer, _interpolate_pos_embed
from nwhead_tpu_torch.ops.fused_attn import _layer_norm_f32, fused_attention_block_bf16
from nwhead_tpu_torch.ops.fused_mlp import fused_mlp_block_bf16

_BF16 = torch.bfloat16


def q_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = LN_EPS) -> torch.Tensor:
    """``QLayerNorm`` of the JAX package (``models/quantize.py``): f32
    statistics with the biased variance, bf16 out."""
    return _layer_norm_f32(x, scale, bias, eps).to(_BF16)


class ServingViTBlock(nn.Module):
    """One block's serving weights: matrices bf16 as (in, out), biases,
    LayerNorm affines and LayerScale gammas f32 (K10/K11 round the gammas
    to bf16)."""

    def __init__(self, blk) -> None:
        super().__init__()
        f32 = torch.float32

        def put(name, t, dtype):  # a copy: later edits of the model do not reach it
            self.register_buffer(
                name, None if t is None else t.detach().to(dtype, copy=True).contiguous())

        put("norm1_scale", blk.norm1.weight, f32)
        put("norm1_bias", blk.norm1.bias, f32)
        put("w_qkv", blk.attn.qkv.weight.t(), _BF16)
        put("b_qkv", blk.attn.qkv.bias, f32)
        put("w_proj", blk.attn.proj.weight.t(), _BF16)
        put("b_proj", blk.attn.proj.bias, f32)
        put("ls1", blk.ls1_gamma, f32)
        put("norm2_scale", blk.norm2.weight, f32)
        put("norm2_bias", blk.norm2.bias, f32)
        put("w_fc1", blk.mlp.fc1.weight.t(), _BF16)
        put("b_fc1", blk.mlp.fc1.bias, f32)
        put("w_fc2", blk.mlp.fc2.weight.t(), _BF16)
        put("b_fc2", blk.mlp.fc2.bias, f32)
        put("ls2", blk.ls2_gamma, f32)

    def forward(self, x: torch.Tensor, num_heads: int) -> torch.Tensor:
        x = fused_attention_block_bf16(
            x, self.w_qkv, self.b_qkv, self.w_proj, self.b_proj, num_heads,
            ln_scale=self.norm1_scale, ln_bias=self.norm1_bias, layerscale=self.ls1,
            residual=True)
        return fused_mlp_block_bf16(
            x, self.w_fc1, self.b_fc1, self.w_fc2, self.b_fc2, ln_scale=self.norm2_scale,
            ln_bias=self.norm2_bias, layerscale=self.ls2, residual=True)


class ServingViT(nn.Module):
    """NHWC float images -> the CLS feature ``(B, D)`` in f32, through
    K10 and K11. Holds buffers only (no parameters): inference only."""

    def __init__(self, model: VisionTransformer) -> None:
        super().__init__()
        f32 = torch.float32
        self.patch_size, self.num_heads = model.patch_size, model.num_heads
        self.register_buffer("patch_w", model.patch_embed.weight.detach().to(_BF16).contiguous())
        self.register_buffer("patch_b", model.patch_embed.bias.detach().to(f32).clone())
        self.register_buffer("cls_token", model.cls_token.detach().to(f32).clone())
        self.register_buffer("pos_embed", model.pos_embed.detach().to(f32).clone())
        self.blocks = nn.ModuleList(ServingViTBlock(blk) for blk in model.blocks)
        self.register_buffer("norm_scale", model.norm.weight.detach().to(f32).clone())
        self.register_buffer("norm_bias", model.norm.bias.detach().to(f32).clone())

    @property
    def feat_dim(self) -> int:
        return self.patch_w.shape[0]

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        D = self.feat_dim
        x = F.conv2d(x.to(_BF16).permute(0, 3, 1, 2), self.patch_w, stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2) + self.patch_b.to(_BF16)  # (B, gh gw, D) bf16
        patch_pos = _interpolate_pos_embed(self.pos_embed[:, 1:], gh * gw, gh, gw)
        x = x + patch_pos.to(_BF16)
        cls_tok = (self.cls_token + self.pos_embed[:, :1]).to(_BF16)
        x = torch.cat([cls_tok.expand(B, 1, D), x], dim=1).contiguous()
        for blk in self.blocks:
            x = blk(x, self.num_heads)
        return q_layer_norm(x, self.norm_scale, self.norm_bias)[:, 0].to(torch.float32)


def fuse_vit_serving(model: VisionTransformer) -> ServingViT:
    """Freeze a ``VisionTransformer``'s weights into the bf16 serving graph
    (no calibration), on the model's device."""
    if not isinstance(model, VisionTransformer):
        raise NotImplementedError(
            f"fuse_vit_serving takes a ViT, got {type(model).__name__}")
    return ServingViT(model).eval()
