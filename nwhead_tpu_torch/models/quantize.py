"""int8 post-training quantization of the serving featurizer.

Port of the ViT part of ``nwhead_tpu/models/quantize.py`` (``QDense``,
``QLayerNorm`` as ``serving_vit.q_layer_norm``, ``QViTBlock``,
``QuantizedViT``, ``quantize_vit``) and its dispatcher
``quantize_featurizer``. Every Dense of a block (qkv, proj, fc1, fc2) runs
on int8 codes: per-output-channel weight scales ``amax/127`` along the
``(in, out)`` kernel's axis 0, and a per-tensor activation scale
calibrated as ``max |input| / 127`` over the calibration images. The
LayerNorms, the attention softmax and the GELU stay f32; the attention
products, the residual stream and the patch embedding bf16. Each block is
two kernels: K10 int8 (``fused_attention_qkv_int8``) and K11 int8
(``fused_mlp_int8``); the stem, final LayerNorm and CLS feature are
``ServingViT``'s.

ResNet/ResNeXt and DenseNet quantization and the ``save_quantized`` /
``load_quantized`` artifacts are later slices (ROADMAP.md queue 1, item 8).
Serving only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nwhead_tpu_torch.models.serving_vit import ServingViT
from nwhead_tpu_torch.models.vit import LN_EPS, VisionTransformer, _interpolate_pos_embed
from nwhead_tpu_torch.ops.fused_attn import (
    _layer_norm_f32, fused_attention_qkv_int8, int8_dense_f32,
)
from nwhead_tpu_torch.ops.fused_mlp import fused_mlp_int8


class QDense(nn.Module):
    """An int8 Dense: ``wq (in, out)`` int8, ``w_scale (out,)`` and ``bias
    (out,)`` f32, and the per-tensor input scale ``act_scale`` (a Python
    float, the f32 value). Called on its own it is the JAX ``QDense``:
    ``x * (1/act_scale)`` with the reciprocal taken in f32, rounded,
    clipped, the int8 product, ``* (act_scale * w_scale) + bias``, bf16 out.
    The half-block kernels read its tensors."""

    def __init__(self, wq: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                 act_scale: float) -> None:
        super().__init__()
        self.register_buffer("wq", wq.to(torch.int8).contiguous())
        self.register_buffer("w_scale", w_scale.to(torch.float32).contiguous())
        self.register_buffer("bias", bias.to(torch.float32).contiguous())
        self.act_scale = float(np.float32(act_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = float(np.float32(1.0) / np.float32(self.act_scale))  # an f32 division
        codes = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
        y = int8_dense_f32(codes, self.wq, self.act_scale, self.w_scale, self.bias)
        return y.to(torch.bfloat16)


class QViTBlock(nn.Module):
    """One quantized block: LayerNorm affines and LayerScale gammas f32 (the
    kernels round the gammas to bf16), the four Denses int8."""

    def __init__(self, norm1: Sequence[torch.Tensor], qkv: QDense, proj: QDense,
                 ls1: Optional[torch.Tensor], norm2: Sequence[torch.Tensor], fc1: QDense,
                 fc2: QDense, ls2: Optional[torch.Tensor]) -> None:
        super().__init__()
        f32 = torch.float32

        def put(name, t):
            self.register_buffer(name, None if t is None else t.detach().to(f32).contiguous())

        put("norm1_scale", norm1[0])
        put("norm1_bias", norm1[1])
        put("ls1", ls1)
        put("norm2_scale", norm2[0])
        put("norm2_bias", norm2[1])
        put("ls2", ls2)
        self.qkv, self.proj, self.fc1, self.fc2 = qkv, proj, fc1, fc2

    def forward(self, x: torch.Tensor, num_heads: int) -> torch.Tensor:
        q, p = self.qkv, self.proj
        x = fused_attention_qkv_int8(
            x, q.wq, q.w_scale, q.bias, q.act_scale, p.wq, p.w_scale, p.bias, p.act_scale,
            num_heads, ln_scale=self.norm1_scale, ln_bias=self.norm1_bias,
            layerscale=self.ls1, residual=True)
        f1, f2 = self.fc1, self.fc2
        return fused_mlp_int8(
            x, f1.wq, f1.w_scale, f1.bias, f1.act_scale, f2.wq, f2.w_scale, f2.bias,
            f2.act_scale, ln_scale=self.norm2_scale, ln_bias=self.norm2_bias,
            layerscale=self.ls2, residual=True)


class QuantizedViT(ServingViT):
    """NHWC float images -> the CLS feature ``(B, D)`` in f32 through K10
    int8 and K11 int8 per block; ``ServingViT``'s stem, final LayerNorm and
    forward. ``patch_w`` is the OIHW patch-embedding kernel (held in bf16);
    ``cls_token``, ``pos_embed``, the biases and the final LayerNorm f32."""

    def __init__(self, patch_w: torch.Tensor, patch_b: torch.Tensor, cls_token: torch.Tensor,
                 pos_embed: torch.Tensor, norm_scale: torch.Tensor, norm_bias: torch.Tensor,
                 patch_size: int, num_heads: int, blocks: Sequence[QViTBlock]) -> None:
        nn.Module.__init__(self)  # ServingViT's layout, built from tensors
        f32 = torch.float32
        self.patch_size, self.num_heads = int(patch_size), int(num_heads)
        self.register_buffer("patch_w", patch_w.detach().to(torch.bfloat16).contiguous())
        for name, t in (("patch_b", patch_b), ("cls_token", cls_token), ("pos_embed", pos_embed),
                        ("norm_scale", norm_scale), ("norm_bias", norm_bias)):
            self.register_buffer(name, t.detach().to(f32).clone())
        self.blocks = nn.ModuleList(blocks)


def _quantize_weight(layer: nn.Linear, act_amax: float) -> QDense:
    """Per-output-channel int8 weights of a Linear (the flax ``(in, out)``
    kernel is its weight transposed) and the activation scale from the
    calibrated amax, as ``quantize_vit``'s ``qdense`` computes them."""
    w = layer.weight.detach().to(torch.float32).t().cpu()
    amax_w = torch.amax(torch.abs(w), dim=0)
    w_scale = torch.where(amax_w > 0, amax_w / 127.0, torch.ones(()))
    wq = torch.clamp(torch.round(w / w_scale), -127, 127)
    act = float(np.float32(act_amax / 127.0)) if act_amax > 0 else 1.0
    dev = layer.weight.device
    return QDense(wq.to(dev), w_scale.to(dev), layer.bias.detach().to(dev), act)


@torch.inference_mode()
def _calibration_amaxes(model: VisionTransformer, x: torch.Tensor) -> List[torch.Tensor]:
    """The JAX calibration forward (``quantize.py:895-947``) in f32: each
    Dense input's ``max |.|`` -- norm1 out (qkv), attention out (proj),
    norm2 out (fc1), GELU out (fc2) -- in block order. Exact GELU, the
    softmax in f32, the parameters in f32."""
    f32 = torch.float32
    amaxes: List[torch.Tensor] = []

    def note(t):
        amaxes.append(torch.amax(torch.abs(t)))
        return t

    def ln(t, norm):
        return _layer_norm_f32(t, norm.weight, norm.bias, LN_EPS)

    def dense(t, layer):
        return torch.matmul(t, layer.weight.to(f32).t()) + layer.bias.to(f32)

    B, H, W, _ = x.shape
    p, D = model.patch_size, model.embed_dim
    gh, gw = H // p, W // p
    t = F.conv2d(x.to(f32).permute(0, 3, 1, 2), model.patch_embed.weight.to(f32),
                 model.patch_embed.bias.to(f32), stride=p)
    t = t.flatten(2).transpose(1, 2)
    pos = model.pos_embed.to(f32)
    t = t + _interpolate_pos_embed(pos[:, 1:], gh * gw, gh, gw)
    cls_tok = model.cls_token.to(f32) + pos[:, :1]
    t = torch.cat([cls_tok.expand(B, 1, D), t], dim=1)
    heads = model.num_heads
    hd = D // heads
    for blk in model.blocks:
        h = dense(note(ln(t, blk.norm1)), blk.attn.qkv)
        N = h.shape[1]
        q, k, v = h.reshape(B, N, 3, heads, hd).unbind(2)
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, D)
        out = dense(note(out), blk.attn.proj)
        if blk.ls1_gamma is not None:
            out = out * blk.ls1_gamma.to(f32)
        t = t + out
        h = dense(note(ln(t, blk.norm2)), blk.mlp.fc1)
        h = F.gelu(h, approximate="none")
        h = dense(note(h), blk.mlp.fc2)
        if blk.ls2_gamma is not None:
            h = h * blk.ls2_gamma.to(f32)
        t = t + h
    return amaxes


def calibrate_vit(model: VisionTransformer, calib_images, calib_batch: int = 64) -> np.ndarray:
    """Each Dense input's amax over the calibration images (a running max
    over batches of ``calib_batch``), as f32 numpy, in block order."""
    dev = next(model.parameters()).device
    total = None
    for start in range(0, len(calib_images), calib_batch):
        chunk = torch.as_tensor(np.asarray(calib_images[start:start + calib_batch])).to(dev)
        amax = torch.stack(_calibration_amaxes(model, chunk)).cpu().numpy()
        total = amax if total is None else np.maximum(total, amax)
    return total


def quantize_vit(model: VisionTransformer, calib_images, calib_batch: int = 64) -> QuantizedViT:
    """int8 PTQ of a ``VisionTransformer`` (``quantize.py:quantize_vit``):
    activation scales calibrated on ``calib_images`` (NHWC, post-transform),
    weights quantized per output channel. On the model's device."""
    amaxes = iter(float(a) for a in calibrate_vit(model, calib_images, calib_batch))
    blocks = []
    for blk in model.blocks:
        qkv = _quantize_weight(blk.attn.qkv, next(amaxes))
        proj = _quantize_weight(blk.attn.proj, next(amaxes))
        fc1 = _quantize_weight(blk.mlp.fc1, next(amaxes))
        fc2 = _quantize_weight(blk.mlp.fc2, next(amaxes))
        blocks.append(QViTBlock((blk.norm1.weight, blk.norm1.bias), qkv, proj, blk.ls1_gamma,
                                (blk.norm2.weight, blk.norm2.bias), fc1, fc2, blk.ls2_gamma))
    return QuantizedViT(model.patch_embed.weight, model.patch_embed.bias, model.cls_token,
                        model.pos_embed, model.norm.weight, model.norm.bias, model.patch_size,
                        model.num_heads, blocks).eval()


def quantize_featurizer(model: nn.Module, calib_images, calib_batch: int = 64) -> nn.Module:
    """The int8 serving featurizer of a backbone, dispatched by family: the
    ViTs are ported; the ResNet/ResNeXt and DenseNet PTQ are not yet."""
    if isinstance(model, VisionTransformer):
        return quantize_vit(model, calib_images, calib_batch)
    raise NotImplementedError(
        f"quantize_featurizer of a {type(model).__name__} (the ResNet/ResNeXt and DenseNet "
        "int8 PTQ) is not ported yet (ROADMAP.md queue 1, item 8); the ViTs are")
