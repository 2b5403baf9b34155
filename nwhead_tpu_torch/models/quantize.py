"""int8 post-training quantization of the serving featurizer.

Port of ``nwhead_tpu/models/quantize.py``: the ResNet/ResNeXt PTQ
(``QConv``, ``QBlock``, ``QuantizedResNet``, ``quantize_resnet``,
``folded_forward``), the DenseNet-BC PTQ (``QAffine``, ``QDenseLayer``,
``QuantizedDenseNet``, ``quantize_densenet``), the ViT PTQ (``QDense``,
``QLayerNorm`` as ``serving_vit.q_layer_norm``, ``QViTBlock``,
``QuantizedViT``, ``quantize_vit``), their dispatcher
``quantize_featurizer`` and the serving artifacts ``save_quantized`` /
``load_quantized``, in JAX's ``.npz`` layout, so that an artifact crosses
between the packages both ways. Serving only: training stays f32/bf16.

The scheme is JAX's. Weights symmetric per output channel (``amax/127``);
activations symmetric per tensor, their scales ``max |input| / 127`` over
the calibration images, from an f32 forward.

* ResNets and ResNeXts: each BatchNorm folded into the conv before it, in
  numpy f32 in JAX's order, so that ``wq``, ``w_scale`` and ``bias`` equal
  JAX's from the same weights bit for bit. Every conv but the stem runs on
  int8 codes (``QConv``: ``ops/int8_conv.py``'s exact int32 conv between
  the quantize and dequantize steps of ``ops/fused_attn.py``), the
  activations carried in bf16 between convs; the stem stays a bf16 conv,
  then max-pool, then its folded bias and ReLU (they commute with the
  window max).
* DenseNet-BC: pre-activation, so BatchNorm cannot fold across the ReLU
  and stays a per-channel affine (``QAffine``: f32 math, bf16 out); every
  conv runs on int8 codes with a zero bias; the transition's 2x2 average
  pool sums in bf16 in JAX's order.
* ViTs: every Dense of a block (qkv, proj, fc1, fc2) on int8 codes, the
  per-channel weight scales along the ``(in, out)`` kernel's axis 0. The
  LayerNorms, the attention softmax and the GELU stay f32; the attention
  products, the residual stream and the patch embedding bf16. Each block
  is two kernels: K10 int8 (``fused_attention_qkv_int8``) and K11 int8
  (``fused_mlp_int8``); the stem, final LayerNorm and CLS feature are
  ``ServingViT``'s.

The CIFAR ResNets and DenseNet and the ``s2d`` stem are refused, as in JAX.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nwhead_tpu_torch.models.densenet import DenseNet
from nwhead_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from nwhead_tpu_torch.models.serving_vit import ServingViT
from nwhead_tpu_torch.models.vit import LN_EPS, VisionTransformer, _interpolate_pos_embed
from nwhead_tpu_torch.ops.fused_attn import (
    _layer_norm_f32, fused_attention_qkv_int8, int8_dense_f32, int8_epilogue, quantize_act,
)
from nwhead_tpu_torch.ops.fused_mlp import fused_mlp_int8
from nwhead_tpu_torch.ops.int8_conv import gemm_weight, int8_conv2d

_BF16 = torch.bfloat16


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
        codes = quantize_act(x, self.act_scale)
        y = int8_dense_f32(codes, self.wq, self.act_scale, self.w_scale, self.bias)
        return y.to(_BF16)


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


def _quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of an f32 weight whose last axis
    is the output channel (HWIO, or a Dense's ``(in, out)``): ``(wq int8,
    scale f32)``, JAX's ``_quantize_weight`` op for op."""
    amax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale


def _act_scale(amax: float) -> float:
    """The activation scale of a calibrated amax, as an f32 value."""
    return float(np.float32(amax / 127.0)) if amax > 0 else 1.0


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _quantize_dense(layer: nn.Linear, act_amax: float) -> QDense:
    """Per-output-channel int8 weights of a Linear (the flax ``(in, out)``
    kernel is its weight transposed) and the activation scale from the
    calibrated amax, as ``quantize_vit``'s ``qdense`` computes them."""
    wq, w_scale = _quantize_weight(np.ascontiguousarray(_np32(layer.weight).T))
    dev = layer.weight.device
    return QDense(torch.from_numpy(wq).to(dev), torch.from_numpy(w_scale).to(dev),
                  layer.bias.detach().to(dev), _act_scale(act_amax))


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
        qkv = _quantize_dense(blk.attn.qkv, next(amaxes))
        proj = _quantize_dense(blk.attn.proj, next(amaxes))
        fc1 = _quantize_dense(blk.mlp.fc1, next(amaxes))
        fc2 = _quantize_dense(blk.mlp.fc2, next(amaxes))
        blocks.append(QViTBlock((blk.norm1.weight, blk.norm1.bias), qkv, proj, blk.ls1_gamma,
                                (blk.norm2.weight, blk.norm2.bias), fc1, fc2, blk.ls2_gamma))
    return QuantizedViT(model.patch_embed.weight, model.patch_embed.bias, model.cls_token,
                        model.pos_embed, model.norm.weight, model.norm.bias, model.patch_size,
                        model.num_heads, blocks).eval()




# ---------------------------------------------------------------------------
# The CNNs: int8 convs, activations NHWC and bf16 between them.
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # a view: the convs take NHWC strides as they are


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def stem_conv_bf16(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The bf16 stem conv of the quantized CNNs (the stem is not int8, as
    in JAX): NHWC images and an OIHW kernel rounded to bf16, a bf16 NHWC
    result. On the CPU it is the f32 conv of the bf16-rounded operands,
    rounded once to bf16, which equals XLA's bf16 conv there (PyTorch's
    native bf16 conv on the CPU rounds differently); on the card cuDNN's
    bf16 conv, which sums the same products in f32."""
    xb, wb = _nchw(x.to(_BF16)), w.to(_BF16)
    if x.device.type == "cpu":
        y = F.conv2d(xb.float(), wb.float(), stride=stride, padding=padding).to(_BF16)
    else:
        y = F.conv2d(xb, wb, stride=stride, padding=padding)
    return _nhwc(y)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """The stems' 3x3/s2/p1 max-pool of an NHWC tensor (padding -inf, as
    JAX's ``reduce_window``)."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))


def _padding(p) -> int:
    """A JAX conv padding (``'VALID'`` or ``((p, p), (p, p))``) as the
    symmetric int the port's convs take."""
    if isinstance(p, str):
        if p != "VALID":
            raise ValueError(f"conv padding {p!r}: need 'VALID' or explicit pairs")
        return 0
    pairs = [tuple(int(v) for v in pair) for pair in p]
    if len(pairs) != 2 or len({v for pair in pairs for v in pair}) != 1:
        raise ValueError(f"conv padding {p!r}: the port takes symmetric paddings only")
    return pairs[0][0]


def _padding_meta(p: int):
    """The JAX form of a symmetric padding: ``'VALID'`` for 0 (the 1x1
    convs), else ``[[p, p], [p, p]]``."""
    return "VALID" if p == 0 else [[p, p], [p, p]]


class QConv(nn.Module):
    """One int8 conv (BN-folded in a ResNet): ``wq`` HWIO int8, ``w_scale``
    and ``bias (cout,)`` f32, the per-tensor input scale ``act_scale`` (a
    Python float, the f32 value), ``stride``, symmetric ``padding`` and
    ``groups``. ``forward`` is JAX's ``_qconv_apply_split``: codes
    ``clip(round(x * (1 / a)), -127, 127)`` with the reciprocal in f32, the
    exact int32 conv (``int8_conv2d``), then ``acc * (a * w_scale) + bias``
    in f32, bf16 out. ``w_gemm`` keeps the CUDA route's GEMM operand
    (``gemm_weight``: block-diagonal for a grouped conv)."""

    def __init__(self, wq: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                 act_scale: float, stride: int, padding: int, groups: int = 1) -> None:
        super().__init__()
        self.register_buffer("wq", wq.to(torch.int8).contiguous())
        self.register_buffer("w_scale", w_scale.to(torch.float32).contiguous())
        self.register_buffer("bias", bias.to(torch.float32).contiguous())
        self.register_buffer("w_gemm", gemm_weight(self.wq, groups))
        self.act_scale = float(np.float32(act_scale))
        self.stride, self.padding, self.groups = int(stride), int(padding), int(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        codes = quantize_act(x, self.act_scale).to(torch.int8)
        acc = int8_conv2d(codes, self.wq, self.stride, self.padding, self.groups, self.w_gemm)
        return int8_epilogue(acc.to(torch.float32), self.act_scale, self.w_scale,
                             self.bias).to(_BF16)


class QBlock(nn.Module):
    """A quantized residual block: ``kind`` ``'basic'`` (two 3x3 convs) or
    ``'bottleneck'`` (1x1, 3x3, 1x1), the optional downsample conv on the
    block's input."""

    def __init__(self, kind: str, convs: Sequence[QConv], downsample: Optional[QConv]) -> None:
        super().__init__()
        if kind not in ("basic", "bottleneck") or len(convs) != (2 if kind == "basic" else 3):
            raise ValueError(f"QBlock kind {kind!r} with {len(convs)} convs")
        self.kind = kind
        self.convs = nn.ModuleList(convs)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for conv in self.convs[:-1]:
            out = F.relu(conv(out))
        out = self.convs[-1](out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class QuantizedResNet(nn.Module):
    """Serving-only quantized ResNet/ResNeXt: NHWC float images -> pooled
    f32 features, JAX's ``_qresnet_forward``: the bf16 stem conv, the
    max-pool, then the folded stem bias and ReLU in bf16 (both commute with
    the window max), the int8 blocks with bf16 activations, the mean over
    H, W in f32. ``stem_w`` is the folded OIHW stem kernel (held in bf16),
    ``stem_b`` its folded bias (f32)."""

    def __init__(self, stem_w: torch.Tensor, stem_b: torch.Tensor, stem_stride: int,
                 stem_padding: int, blocks: Sequence[QBlock]) -> None:
        super().__init__()
        self.register_buffer("stem_w", stem_w.detach().to(_BF16).contiguous())
        self.register_buffer("stem_b", stem_b.detach().to(torch.float32).contiguous())
        self.stem_stride, self.stem_padding = int(stem_stride), int(stem_padding)
        self.blocks = nn.ModuleList(blocks)

    @property
    def feat_dim(self) -> int:
        return self.blocks[-1].convs[-1].wq.shape[-1]

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _max_pool(stem_conv_bf16(x, self.stem_w, self.stem_stride, self.stem_padding))
        x = F.relu(x + self.stem_b.to(_BF16))
        for blk in self.blocks:
            x = blk(x)
        return torch.mean(x.to(torch.float32), dim=(1, 2))


def _hwio(w: torch.Tensor) -> np.ndarray:
    """An OIHW conv weight as an f32 HWIO numpy array (the flax kernel)."""
    return np.ascontiguousarray(_np32(w).transpose(2, 3, 1, 0))


def _bn_np(bn: nn.BatchNorm2d):
    return tuple(_np32(t) for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the bias-free conv before it, in
    numpy f32 in JAX's order (``_fold_conv_bn``): ``w * (gamma * inv_std)``,
    ``beta - gamma * mean * inv_std`` with ``inv_std = 1 / sqrt(var + eps)``.
    Returns the HWIO weight and the bias. The parameters are read as f32
    whatever the model's compute dtype, as JAX's fold reads f32 numpy."""
    w = _hwio(conv.weight)
    gamma, beta, mean, var = _bn_np(bn)
    inv_std = 1.0 / np.sqrt(var + eps)
    return w * (gamma * inv_std), beta - gamma * mean * inv_std


def _folded_layers(model: ResNet) -> Tuple[Dict, List[Dict]]:
    """The folded stem and each block's folded conv descriptors (``w``
    HWIO f32, ``b``, ``stride``, ``padding``, ``groups``) in forward order,
    as JAX's ``_folded_layers``; refuses what JAX refuses."""
    if model.stem != "conv7":
        raise NotImplementedError(
            "quantize_featurizer supports the conv7 stem (the s2d stem is an experiment flag; "
            "quantize the conv7 form instead)")
    if model.block not in (BasicBlock, Bottleneck):
        raise NotImplementedError(
            f"quantize_featurizer supports BasicBlock/Bottleneck ResNets, got "
            f"{model.block.__name__}")
    w, b = _fold_conv_bn(model.conv1, model.bn1)
    stem = {"w": w, "b": b, "stride": 2, "padding": 3}
    blocks = []
    for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in stage:
            names = (("conv1", "bn1"), ("conv2", "bn2")) + (
                (("conv3", "bn3"),) if isinstance(blk, Bottleneck) else ())
            convs = []
            for cname, bname in names:
                conv = getattr(blk, cname)
                w, b = _fold_conv_bn(conv, getattr(blk, bname))
                convs.append({"w": w, "b": b, "stride": conv.stride[0], "padding": conv.padding[0],
                              "groups": conv.groups})
            ds = None
            if blk.downsample is not None:
                conv, bn = blk.downsample[0], blk.downsample[1]
                w, b = _fold_conv_bn(conv, bn)
                ds = {"w": w, "b": b, "stride": conv.stride[0], "padding": 0, "groups": 1}
            blocks.append({"kind": "bottleneck" if isinstance(blk, Bottleneck) else "basic",
                           "convs": convs, "ds": ds})
    return stem, blocks


def _conv_f32(t: torch.Tensor, desc: Dict, dev) -> torch.Tensor:
    """An f32 NHWC conv (+ bias) of a folded descriptor, for the
    calibration forward."""
    w = torch.from_numpy(np.ascontiguousarray(desc["w"].transpose(3, 2, 0, 1))).to(dev)
    b = torch.from_numpy(np.asarray(desc["b"], np.float32)).to(dev)
    y = F.conv2d(_nchw(t), w, b, stride=desc["stride"], padding=desc["padding"],
                 groups=desc.get("groups", 1))
    return _nhwc(y)


@torch.inference_mode()
def _folded_run(stem: Dict, blocks: List[Dict], x: torch.Tensor,
                record: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The BN-folded f32 forward (JAX's ``_folded_run``): pooled features
    and, with ``record``, each quantized conv's input amax, taken at the
    block input and then after each ReLU'd intermediate (the downsample
    reuses the block input's)."""
    dev = x.device
    amaxes: List[torch.Tensor] = []

    def note(t):
        if record:
            amaxes.append(torch.amax(torch.abs(t)))

    x = _max_pool(F.relu(_conv_f32(x.to(torch.float32), stem, dev)))
    for blk in blocks:
        out = x
        note(out)
        for desc in blk["convs"][:-1]:
            out = F.relu(_conv_f32(out, desc, dev))
            note(out)
        out = _conv_f32(out, blk["convs"][-1], dev)
        identity = x if blk["ds"] is None else _conv_f32(x, blk["ds"], dev)
        x = F.relu(out + identity)
    return torch.mean(x, dim=(1, 2)), amaxes


def folded_forward(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """The f32 forward through the BN-folded serving graph: equals the
    model's eval forward up to f32 rounding (the fold's oracle), and is the
    calibration forward."""
    stem, blocks = _folded_layers(model)
    return _folded_run(stem, blocks, x, record=False)[0]


def _running_amax(run, calib_images, calib_batch: int, dev) -> np.ndarray:
    """Each recorded amax's running max over the calibration images in
    batches of ``calib_batch``, as f32 numpy."""
    total = None
    for start in range(0, len(calib_images), calib_batch):
        chunk = torch.as_tensor(np.asarray(calib_images[start:start + calib_batch])).to(dev)
        amax = torch.stack(run(chunk)).cpu().numpy()
        total = amax if total is None else np.maximum(total, amax)
    return total


def _qconv(desc: Dict, act_scale: float, dev, w: Optional[np.ndarray] = None) -> QConv:
    """A ``QConv`` of a conv descriptor (its ``w`` quantized per output
    channel, unless ``w`` is given), on ``dev``."""
    wq, w_scale = _quantize_weight(desc["w"] if w is None else w)
    bias = desc.get("b")
    bias = np.zeros(wq.shape[-1], np.float32) if bias is None else np.asarray(bias, np.float32)
    return QConv(torch.from_numpy(wq), torch.from_numpy(w_scale), torch.from_numpy(bias),
                 act_scale, desc["stride"], desc["padding"], desc.get("groups", 1)).to(dev)


def quantize_resnet(model: ResNet, calib_images, calib_batch: int = 64) -> QuantizedResNet:
    """int8 PTQ of an ImageNet ResNet/ResNeXt (``quantize.py:quantize_featurizer``'s
    ResNet branch): BN folded, each conv's activation scale calibrated on
    ``calib_images`` (NHWC, post-transform) through the folded f32 forward,
    weights quantized per output channel. On the model's device."""
    dev = next(model.parameters()).device
    stem, blocks = _folded_layers(model)
    amaxes = _running_amax(lambda xs: _folded_run(stem, blocks, xs, record=True)[1],
                           calib_images, calib_batch, dev)
    it = iter(float(a) for a in amaxes)
    qblocks = []
    for blk in blocks:
        convs = [_qconv(c, _act_scale(next(it)), dev) for c in blk["convs"]]
        # The downsample takes the block's input: conv1's scale.
        ds = None if blk["ds"] is None else _qconv(blk["ds"], convs[0].act_scale, dev)
        qblocks.append(QBlock(blk["kind"], convs, ds))
    return QuantizedResNet(torch.from_numpy(np.ascontiguousarray(stem["w"].transpose(3, 2, 0, 1))),
                           torch.from_numpy(np.asarray(stem["b"], np.float32)), stem["stride"],
                           stem["padding"], qblocks).to(dev).eval()


class QAffine(nn.Module):
    """An eval-mode BatchNorm as ``y = x * scale + shift`` per channel of an
    NHWC tensor: f32 math, bf16 out."""

    def __init__(self, scale: torch.Tensor, shift: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("scale", scale.to(torch.float32).contiguous())
        self.register_buffer("shift", shift.to(torch.float32).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.float32) * self.scale + self.shift).to(_BF16)


class QDenseLayer(nn.Module):
    """A quantized dense layer: BN-ReLU-int8 1x1 -> BN-ReLU-int8 3x3."""

    def __init__(self, bn1: QAffine, conv1: QConv, bn2: QAffine, conv2: QConv) -> None:
        super().__init__()
        self.bn1, self.conv1, self.bn2, self.conv2 = bn1, conv1, bn2, conv2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        return self.conv2(F.relu(self.bn2(h)))


class QTransition(nn.Module):
    """A quantized transition: BN-ReLU-int8 1x1, then the 2x2 average pool
    in bf16 (``avg_pool2_bf16``)."""

    def __init__(self, bn: QAffine, conv: QConv) -> None:
        super().__init__()
        self.bn, self.conv = bn, conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2_bf16(self.conv(F.relu(self.bn(x))))


def avg_pool2_bf16(h: torch.Tensor) -> torch.Tensor:
    """JAX's bf16 ``reduce_window(add)`` over 2x2/s2 windows, then ``*
    0.25``, of an NHWC bf16 tensor: the four taps summed in row-major window
    order, ``((h00 + h01) + h10) + h11``, each partial sum rounded to bf16
    (``F.avg_pool2d`` sums in f32 and rounds once: another function)."""
    H, W = h.shape[1] // 2 * 2, h.shape[2] // 2 * 2
    h = h[:, :H, :W]
    s = h[:, 0::2, 0::2] + h[:, 0::2, 1::2]
    s = s + h[:, 1::2, 0::2]
    s = s + h[:, 1::2, 1::2]
    return s * 0.25


class QuantizedDenseNet(nn.Module):
    """Serving-only quantized DenseNet-BC: NHWC float images -> pooled f32
    features, JAX's ``_qdensenet_forward``: the bf16 stem conv (``stem_w``
    OIHW, no bias), ``relu(bn0)``, the max-pool, the dense blocks (each
    layer's new features concatenated after the block's), a transition
    after every block but the last, ``relu(final_bn)``, the mean in f32."""

    def __init__(self, stem_w: torch.Tensor, bn0: QAffine,
                 blocks: Sequence[Sequence[QDenseLayer]], transitions: Sequence[QTransition],
                 final_bn: QAffine) -> None:
        super().__init__()
        if len(transitions) != len(blocks) - 1:
            raise ValueError(f"{len(blocks)} dense blocks take {len(blocks) - 1} transitions, "
                             f"got {len(transitions)}")
        self.register_buffer("stem_w", stem_w.detach().to(_BF16).contiguous())
        self.bn0, self.final_bn = bn0, final_bn
        self.blocks = nn.ModuleList(nn.ModuleList(layers) for layers in blocks)
        self.transitions = nn.ModuleList(transitions)

    @property
    def feat_dim(self) -> int:
        return self.final_bn.scale.shape[0]

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _max_pool(F.relu(self.bn0(stem_conv_bf16(x, self.stem_w, 2, 3))))
        for i, block in enumerate(self.blocks):
            for layer in block:
                x = torch.cat([x, layer(x)], dim=-1)
            if i < len(self.transitions):
                x = self.transitions[i](x)
        x = F.relu(self.final_bn(x))
        return torch.mean(x.to(torch.float32), dim=(1, 2))


def _bn_affine(bn: nn.BatchNorm2d, eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """An eval-mode BatchNorm's ``(scale, shift)`` in numpy f32, JAX's
    ``_bn_affine`` op for op."""
    gamma, beta, mean, var = _bn_np(bn)
    inv_std = 1.0 / np.sqrt(var + eps)
    return gamma * inv_std, beta - gamma * mean * inv_std


def _qaffine(a: Tuple[np.ndarray, np.ndarray], dev) -> QAffine:
    return QAffine(torch.from_numpy(a[0]), torch.from_numpy(a[1])).to(dev)


def _dense_structure(model: DenseNet):
    """``(stem, blocks, transitions, final)``: the stem conv and norm0,
    each block's dense layers, each transition (the last block has none),
    norm5."""
    f = model.features
    blocks, transitions = [], []
    i = 1
    while hasattr(f, f"denseblock{i}"):
        blocks.append(list(getattr(f, f"denseblock{i}").children()))
        if hasattr(f, f"transition{i}"):
            transitions.append(getattr(f, f"transition{i}"))
        i += 1
    return (f.conv0, f.norm0), blocks, transitions, f.norm5


def quantize_densenet(model: DenseNet, calib_images,
                      calib_batch: int = 64) -> QuantizedDenseNet:
    """int8 PTQ of an ImageNet DenseNet-BC (``quantize.py:quantize_densenet``):
    every conv on int8 codes with a zero bias, each BatchNorm kept as an
    affine precomputed in numpy; each conv's activation scale calibrated on
    ``calib_images`` through an f32 forward that quantizes nothing and
    records each conv's input amax (after ``relu(BN)``, what serving
    quantizes), in JAX's order. On the model's device."""
    dev = next(model.parameters()).device
    (conv0, norm0), blocks, transitions, norm5 = _dense_structure(model)
    aff = {id(bn): _bn_affine(bn) for bn in model.modules() if isinstance(bn, nn.BatchNorm2d)}
    aff_t = {k: tuple(torch.from_numpy(a).to(dev) for a in v) for k, v in aff.items()}

    @torch.inference_mode()
    def run(x):
        amaxes = []

        def bn(t, m):
            scale, shift = aff_t[id(m)]
            return t * scale + shift

        def conv(t, m, note=True):
            if note:
                amaxes.append(torch.amax(torch.abs(t)))
            return _nhwc(F.conv2d(_nchw(t), m.weight.to(torch.float32), stride=m.stride,
                                  padding=m.padding))

        t = conv(x.to(torch.float32), conv0, note=False)
        t = _max_pool(F.relu(bn(t, norm0)))
        for i, layers in enumerate(blocks):
            for layer in layers:
                h = conv(F.relu(bn(t, layer.norm1)), layer.conv1)
                h = conv(F.relu(bn(h, layer.norm2)), layer.conv2)
                t = torch.cat([t, h], dim=-1)
            if i < len(transitions):
                tr = transitions[i]
                h = conv(F.relu(bn(t, tr.norm)), tr.conv)
                t = _nhwc(F.avg_pool2d(_nchw(h), 2, 2))
        return amaxes

    it = iter(float(a) for a in _running_amax(run, calib_images, calib_batch, dev))

    def qconv(m) -> QConv:
        desc = {"w": _hwio(m.weight), "b": None, "stride": m.stride[0], "padding": m.padding[0]}
        return _qconv(desc, _act_scale(next(it)), dev)

    qblocks = []
    qtrans = []
    for i, layers in enumerate(blocks):
        qlayers = []
        for layer in layers:
            bn1, conv1 = _qaffine(aff[id(layer.norm1)], dev), qconv(layer.conv1)
            bn2, conv2 = _qaffine(aff[id(layer.norm2)], dev), qconv(layer.conv2)
            qlayers.append(QDenseLayer(bn1, conv1, bn2, conv2))
        qblocks.append(qlayers)
        if i < len(transitions):
            tr = transitions[i]
            qtrans.append(QTransition(_qaffine(aff[id(tr.norm)], dev), qconv(tr.conv)))
    stem_w = conv0.weight.detach().to(torch.float32)
    return QuantizedDenseNet(stem_w, _qaffine(aff[id(norm0)], dev), qblocks, qtrans,
                             _qaffine(aff[id(norm5)], dev)).to(dev).eval()


def quantize_featurizer(model: nn.Module, calib_images, calib_batch: int = 64) -> nn.Module:
    """The int8 serving featurizer of a backbone, dispatched by family as
    JAX's ``quantize_featurizer``: an ImageNet ResNet/ResNeXt
    (``quantize_resnet``), DenseNet-BC (``quantize_densenet``) or ViT
    (``quantize_vit``); ``calib_images`` NHWC, post-transform. The CIFAR
    variants are refused."""
    if isinstance(model, DenseNet):
        return quantize_densenet(model, calib_images, calib_batch)
    if isinstance(model, VisionTransformer):
        return quantize_vit(model, calib_images, calib_batch)
    if not isinstance(model, ResNet):
        raise NotImplementedError(
            f"quantize_featurizer supports the ImageNet ResNet/ResNeXt, DenseNet-BC, and ViT "
            f"families; got {type(model).__name__} (the CIFAR variants are not supported)")
    return quantize_resnet(model, calib_images, calib_batch)


# ---------------------------------------------------------------------------
# Serving artifacts: quantize once, save, serve. JAX's .npz layout: HWIO
# int8 conv weights, (in, out) Dense weights, bf16 stems and patch kernels
# stored as f32 HWIO (numpy has no bf16; the cast back is exact), the
# static structure in a JSON ``__meta__``.
# ---------------------------------------------------------------------------


def _put_conv(arrays: Dict[str, np.ndarray], prefix: str, qc: QConv) -> Dict:
    arrays[f"{prefix}.wq"] = qc.wq.cpu().numpy()
    arrays[f"{prefix}.w_scale"] = _np32(qc.w_scale)
    arrays[f"{prefix}.bias"] = _np32(qc.bias)
    arrays[f"{prefix}.act_scale"] = np.asarray(qc.act_scale, np.float32)
    return {"stride": qc.stride, "padding": _padding_meta(qc.padding), "groups": qc.groups}


def _put_pair(arrays: Dict[str, np.ndarray], prefix: str, names: Tuple[str, str],
              pair: Tuple[torch.Tensor, torch.Tensor]) -> None:
    for name, t in zip(names, pair):
        arrays[f"{prefix}.{name}"] = _np32(t)


def save_quantized(q: nn.Module, path: str) -> None:
    """Write a quantized featurizer (``QuantizedResNet``,
    ``QuantizedDenseNet`` or ``QuantizedViT``) to one ``.npz`` in the JAX
    package's layout, which its ``load_quantized`` reads."""
    arrays: Dict[str, np.ndarray] = {}
    if isinstance(q, QuantizedResNet):
        arrays["stem_w"] = _hwio(q.stem_w)
        arrays["stem_b"] = _np32(q.stem_b)
        meta = {"family": "resnet", "stem_stride": q.stem_stride,
                "stem_padding": _padding_meta(q.stem_padding),
                "blocks": [{"kind": blk.kind,
                            "convs": [_put_conv(arrays, f"b{i}.c{j}", c)
                                      for j, c in enumerate(blk.convs)],
                            "ds": None if blk.downsample is None
                            else _put_conv(arrays, f"b{i}.ds", blk.downsample)}
                           for i, blk in enumerate(q.blocks)]}
    elif isinstance(q, QuantizedDenseNet):
        arrays["stem_w"] = _hwio(q.stem_w)
        _put_pair(arrays, "bn0", ("scale", "shift"), (q.bn0.scale, q.bn0.shift))
        _put_pair(arrays, "final_bn", ("scale", "shift"), (q.final_bn.scale, q.final_bn.shift))
        meta = {"family": "densenet", "blocks": []}
        for i, layers in enumerate(q.blocks):
            lm = []
            for j, layer in enumerate(layers):
                _put_pair(arrays, f"b{i}.l{j}.bn1", ("scale", "shift"),
                          (layer.bn1.scale, layer.bn1.shift))
                _put_pair(arrays, f"b{i}.l{j}.bn2", ("scale", "shift"),
                          (layer.bn2.scale, layer.bn2.shift))
                lm.append({"conv1": _put_conv(arrays, f"b{i}.l{j}.c1", layer.conv1),
                           "conv2": _put_conv(arrays, f"b{i}.l{j}.c2", layer.conv2)})
            tm = None
            if i < len(q.transitions):
                tr = q.transitions[i]
                _put_pair(arrays, f"t{i}.bn", ("scale", "shift"), (tr.bn.scale, tr.bn.shift))
                tm = _put_conv(arrays, f"t{i}.conv", tr.conv)
            meta["blocks"].append({"layers": lm, "transition": tm})
    elif isinstance(q, QuantizedViT):
        arrays["patch_w"] = _hwio(q.patch_w)
        for name in ("patch_b", "cls_token", "pos_embed"):
            arrays[name] = _np32(getattr(q, name))
        meta = {"family": "vit", "patch_size": q.patch_size, "num_heads": q.num_heads,
                "blocks": []}
        for i, blk in enumerate(q.blocks):
            _put_pair(arrays, f"b{i}.norm1", ("scale", "bias"), (blk.norm1_scale, blk.norm1_bias))
            _put_pair(arrays, f"b{i}.norm2", ("scale", "bias"), (blk.norm2_scale, blk.norm2_bias))
            for name in ("qkv", "proj", "fc1", "fc2"):
                d = getattr(blk, name)
                arrays[f"b{i}.{name}.wq"] = d.wq.cpu().numpy()
                arrays[f"b{i}.{name}.w_scale"] = _np32(d.w_scale)
                arrays[f"b{i}.{name}.bias"] = _np32(d.bias)
                arrays[f"b{i}.{name}.act_scale"] = np.asarray(d.act_scale, np.float32)
            for g in ("ls1", "ls2"):
                if getattr(blk, g) is not None:
                    arrays[f"b{i}.{g}"] = _np32(getattr(blk, g))
            meta["blocks"].append({"ls1": blk.ls1 is not None, "ls2": blk.ls2 is not None})
        _put_pair(arrays, "final_norm", ("scale", "bias"), (q.norm_scale, q.norm_bias))
    else:
        raise NotImplementedError(f"cannot serialize {type(q).__name__}")
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_quantized(path: str, device: Union[str, torch.device] = "cpu") -> nn.Module:
    """Read a ``save_quantized`` artifact of either package (a manifest
    without ``family`` is a ResNet's) into the port's quantized featurizer,
    on ``device``."""
    with np.load(path if str(path).endswith(".npz") else f"{path}.npz") as z:
        meta = json.loads(bytes(z["__meta__"]).decode())

        def t(key: str) -> torch.Tensor:
            return torch.from_numpy(np.array(z[key]))

        def oihw(key: str) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(z[key].transpose(3, 2, 0, 1)))

        def conv(prefix: str, cm: Dict) -> QConv:
            return QConv(t(f"{prefix}.wq"), t(f"{prefix}.w_scale"), t(f"{prefix}.bias"),
                         float(z[f"{prefix}.act_scale"]), cm["stride"],
                         _padding(cm["padding"]), cm["groups"])

        def affine(prefix: str) -> QAffine:
            return QAffine(t(f"{prefix}.scale"), t(f"{prefix}.shift"))

        family = meta.get("family", "resnet")
        if family == "vit":
            def dense(prefix: str) -> QDense:
                return QDense(t(f"{prefix}.wq"), t(f"{prefix}.w_scale"), t(f"{prefix}.bias"),
                              float(z[f"{prefix}.act_scale"]))

            blocks = [QViTBlock(
                (t(f"b{i}.norm1.scale"), t(f"b{i}.norm1.bias")), dense(f"b{i}.qkv"),
                dense(f"b{i}.proj"), t(f"b{i}.ls1") if bm["ls1"] else None,
                (t(f"b{i}.norm2.scale"), t(f"b{i}.norm2.bias")), dense(f"b{i}.fc1"),
                dense(f"b{i}.fc2"), t(f"b{i}.ls2") if bm["ls2"] else None)
                for i, bm in enumerate(meta["blocks"])]
            q = QuantizedViT(oihw("patch_w"), t("patch_b"), t("cls_token"), t("pos_embed"),
                             t("final_norm.scale"), t("final_norm.bias"), meta["patch_size"],
                             meta["num_heads"], blocks)
        elif family == "densenet":
            blocks, transitions = [], []
            for i, bm in enumerate(meta["blocks"]):
                blocks.append([QDenseLayer(affine(f"b{i}.l{j}.bn1"), conv(f"b{i}.l{j}.c1", lm["conv1"]),
                                           affine(f"b{i}.l{j}.bn2"), conv(f"b{i}.l{j}.c2", lm["conv2"]))
                               for j, lm in enumerate(bm["layers"])])
                last = i == len(meta["blocks"]) - 1
                if (bm["transition"] is None) != last:
                    raise ValueError(f"{path}: block {i} {'has' if last else 'lacks'} a "
                                     "transition; every dense block but the last has one")
                if not last:
                    transitions.append(QTransition(affine(f"t{i}.bn"),
                                                   conv(f"t{i}.conv", bm["transition"])))
            q = QuantizedDenseNet(oihw("stem_w"), affine("bn0"), blocks, transitions,
                                  affine("final_bn"))
        elif family == "resnet":
            blocks = [QBlock(bm["kind"], [conv(f"b{i}.c{j}", cm) for j, cm in enumerate(bm["convs"])],
                             conv(f"b{i}.ds", bm["ds"]) if bm["ds"] else None)
                      for i, bm in enumerate(meta["blocks"])]
            q = QuantizedResNet(oihw("stem_w"), t("stem_b"), meta["stem_stride"],
                                _padding(meta["stem_padding"]), blocks)
        else:
            raise ValueError(f"{path}: unknown quantized family {family!r}")
    return q.to(device).eval()
