"""Block lab: ResNet-18's layer1 (two BasicBlocks) as one inference kernel,
beside cuDNN, on the card.

Port of ``scripts/block_lab.py``. ``fused_blocks(x, w, b, n_blocks=2)``
runs ``n_blocks`` BasicBlocks with folded BatchNorm on NHWC bf16
activations ``(B, H, W, C)``, the JAX package's public layout: per block,
``h = bf16(relu(conv3x3(x, w1) + b1))`` and ``bf16(relu(conv3x3(h, w2) + b2 +
x))``, each conv 3x3 with zero padding 1 on bf16 weights, summed in f32,
plus an f32 bias. CUDA tensors run the kernel ``csrc/lab_blocks.cu`` (one
block per 8 x 8 output tile of an image, the halo recomputed; see there),
CPU tensors the plain version ``_fused_blocks_plain``.

``fold_bn`` is the lab's numpy fold (eps 1e-5); ``pack_weights`` packs the
folded convs in the kernel's order, ``(2 n, 9, C_in, C_out)`` bf16 (tap
``3 dy + dx`` of an HWIO kernel) and ``(2 n, C)`` f32 biases. The TPU's
64 x 64 zero-halo layout (``pad_layout``, ``GRID``, ``OFF``) and its
``BLOCK_CONV_IMPL`` variants are Mosaic layouts of the same function and are
not ported. ``fold_flax_blocks`` takes flax ``BasicBlock`` variables as numpy
arrays, ``fold_basic_block`` the port's ``models/resnet.py`` ``BasicBlock``
(eval BN)::

    python -m nwhead_tpu_torch.labs.block_lab
    python -m nwhead_tpu_torch.labs.block_lab --device cpu --tiny

checks the kernel against the port's BasicBlocks run in bf16 (within 2e-2
of max|reference|, as the TPU lab holds its kernel to flax) and against the
plain version (1e-2), then times it beside cuDNN running the same two
BasicBlocks in bf16, channels_last, at B=64.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device
from nwhead_tpu_torch.ops import _cuda

Folded = Tuple[np.ndarray, np.ndarray]  # (w (3, 3, C_in, C_out) HWIO, b (C_out,))
TIMED_BATCH = 64  # the TPU lab's B


def fold_bn(w_hwio, scale, bias, mean, var, eps=1e-5) -> Folded:
    """conv -> BN(eval) == conv with folded weights + bias
    (``scripts/block_lab.py:fold_bn``, the same numpy arithmetic)."""
    a = scale / np.sqrt(var + eps)
    w = np.asarray(w_hwio) * a[None, None, None, :]
    b = bias - mean * a
    return w, b


def pack_weights(folded: Sequence[Folded]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``folded``: one ``(w HWIO, b)`` per conv, ``2 n_blocks`` of them.
    Returns ``(w (2n, 9, C, C) bf16, b (2n, C) f32)`` on the CPU: conv i's
    tap ``3 dy + dx`` as ``(C_in, C_out)``."""
    C = folded[0][0].shape[-1]
    w = np.stack([np.asarray(wi, np.float32).reshape(9, C, C) for wi, _ in folded])
    b = np.stack([np.asarray(bi, np.float32) for _, bi in folded])
    return torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b)


def fold_flax_blocks(variables_list) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed weights of flax ``BasicBlock`` variables (numpy arrays:
    ``params`` ``conv1``/``conv2`` ``kernel`` HWIO, ``bn1``/``bn2``
    ``scale``, ``bias``; ``batch_stats`` ``bn1``/``bn2`` ``mean``, ``var``),
    one dict a block, as the TPU lab folds them."""
    folded = []
    for v in variables_list:
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            folded.append(fold_bn(
                np.asarray(v["params"][conv]["kernel"]),
                np.asarray(v["params"][bn]["scale"]), np.asarray(v["params"][bn]["bias"]),
                np.asarray(v["batch_stats"][bn]["mean"]),
                np.asarray(v["batch_stats"][bn]["var"])))
    return pack_weights(folded)


def fold_basic_block(block) -> List[Folded]:
    """The two folded convs of the port's ``BasicBlock`` (identity shortcut,
    stride 1) with its BatchNorms in eval mode: ``[(w1, b1), (w2, b2)]``,
    HWIO numpy f32."""
    if block.downsample is not None or block.conv1.stride != (1, 1):
        raise ValueError("fused_blocks runs BasicBlocks with an identity shortcut")
    out = []
    for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
        def np32(t):
            return t.detach().to("cpu", torch.float32).numpy()

        out.append(fold_bn(np32(conv.weight).transpose(2, 3, 1, 0), np32(bn.weight),
                           np32(bn.bias), np32(bn.running_mean), np32(bn.running_var),
                           bn.eps))
    return out


def _fused_blocks_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        n_blocks: int = 2) -> torch.Tensor:
    """``fused_blocks``' function in plain PyTorch: f32 convolutions of the
    bf16 values (TF32 off), the intermediates rounded to bf16."""
    C = x.shape[-1]
    # (2n, 9, C_in, C_out) -> (2n, C_out, C_in, 3, 3)
    wf = w.to(torch.float32).reshape(-1, 3, 3, C, C).permute(0, 4, 3, 1, 2)
    h = x.permute(0, 3, 1, 2).to(torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for blk in range(n_blocks):
            i1, i2 = 2 * blk, 2 * blk + 1
            t = F.conv2d(h, wf[i1], padding=1) + b[i1][None, :, None, None]
            t = torch.relu(t).to(torch.bfloat16).to(torch.float32)
            t = F.conv2d(t, wf[i2], padding=1) + b[i2][None, :, None, None]
            h = torch.relu(t + h).to(torch.bfloat16).to(torch.float32)
    return h.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _check(x, w, b, n_blocks) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_blocks takes (B, H, W, C) bf16, got {x.dtype} {tuple(x.shape)}")
    C = x.shape[-1]
    if n_blocks < 1 or w.shape != (2 * n_blocks, 9, C, C) or w.dtype != torch.bfloat16 or \
            b.shape != (2 * n_blocks, C) or b.dtype != torch.float32:
        raise ValueError(f"weights {w.dtype} {tuple(w.shape)} / bias {b.dtype} {tuple(b.shape)} "
                         f"for {n_blocks} blocks of C={C} (pack_weights)")


def fused_blocks_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      n_blocks: int = 2) -> torch.Tensor:
    """Launch L2 ``fused_blocks`` (``csrc/lab_blocks.cu``)."""
    _check(x, w, b, n_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_blocks_cuda needs CUDA tensors, got {x.device}")
    B, H, W, C = x.shape
    if C not in (8, 16, 32, 64):
        raise ValueError(f"fused_blocks_cuda takes C in 8, 16, 32, 64, got {C}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    for arg, t in (("weights", w), ("bias", b)):
        if t.device != x.device:
            raise ValueError(f"fused_blocks_cuda: {arg} on {t.device}, x on {x.device}")
    lib = _cuda.load_library("lab_blocks")  # refuses a tile beyond a block's shared memory
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.lab_fused_blocks(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H,
                                  W, C, n_blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_blocks_cuda kernel launch failed: "
                           f"{lib.lab_blocks_error_string(rc).decode()}")
    fused_blocks_cuda.launches += 1
    return out


fused_blocks_cuda.launches = 0


def fused_blocks(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 n_blocks: int = 2) -> torch.Tensor:
    """``(B, H, W, C)`` bf16 -> ``(B, H, W, C)`` bf16 through ``n_blocks``
    BasicBlocks with folded BN (``pack_weights``' ``w``, ``b``)."""
    _check(x, w, b, n_blocks)
    if x.device.type == "cpu":
        return _fused_blocks_plain(x, w, b, n_blocks)
    return fused_blocks_cuda(x, w, b, n_blocks)


def random_blocks(C: int, n_blocks: int, rng: np.random.Generator, device):
    """``n_blocks`` of the port's ``BasicBlock(C, C)`` in eval mode: weights
    from torch's init under seed 0, BN affine and running statistics drawn
    from ``rng`` (so that the fold is exercised)."""
    from nwhead_tpu_torch.models.resnet import BasicBlock

    torch.manual_seed(0)
    blocks = []
    for _ in range(n_blocks):
        blk = BasicBlock(C, C)
        with torch.no_grad():
            for bn in (blk.bn1, blk.bn2):
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
                bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, C).astype(np.float32)))
                bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.2, C).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(
                    (rng.normal(0.3, 0.2, C) ** 2 + 0.5).astype(np.float32)))
        blocks.append(blk.eval().to(device))
    return blocks


def layer_reference(blocks, x: torch.Tensor) -> torch.Tensor:
    """The BasicBlocks themselves in bf16 (channels_last) on NHWC ``x``:
    cuDNN on the card, the TPU lab's "xla layer1"."""
    h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    for blk in blocks:
        h = blk(h)
    return h.permute(0, 2, 3, 1)


def rel_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def main(argv=None) -> int:
    import copy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small shape (B=2, 16 x 16, C=16)")
    args = ap.parse_args(argv)
    dev = lab_device(args.device)

    B, HW, C = (2, 16, 16) if args.tiny else (8, 56, 64)
    print(f"card: {card_line(dev)}; parity at ({B}, {HW}, {HW}, {C}), timing at B="
          f"{TIMED_BATCH}", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, HW, HW, C)).astype(np.float32)).to(
        dev, torch.bfloat16)
    blocks = random_blocks(C, 2, rng, dev)
    w, b = pack_weights([f for blk in blocks for f in fold_basic_block(blk)])
    w, b = w.to(dev), b.to(dev)
    got = fused_blocks(x, w, b)
    bf_blocks = [copy.deepcopy(blk).to(torch.bfloat16) for blk in blocks]
    with torch.no_grad():
        want = layer_reference(bf_blocks, x)
    err_ref = rel_to_max(got, want)
    err_plain = rel_to_max(got, _fused_blocks_plain(x, w, b))
    print(f"parity vs the port's BasicBlocks in bf16: max rel err {err_ref:.2e}; "
          f"vs the plain version: {err_plain:.2e}", flush=True)
    if not (err_ref < 2e-2 and err_plain < 1e-2):
        print("block_lab: fused_blocks disagrees", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("CPU run: parity checked, timing not measured")
        return 0

    x_t = torch.from_numpy(rng.standard_normal((TIMED_BATCH, HW, HW, C)).astype(np.float32)).to(
        dev, torch.bfloat16)

    def cudnn_layer1(xx):
        with torch.no_grad():
            return layer_reference(bf_blocks, xx)

    res = interleaved_time([("cudnn layer1 (bf16, channels_last)", cudnn_layer1, (x_t,)),
                            ("fused layer1", fused_blocks, (x_t, w, b))])
    for name, t in res.items():
        print(f"{name}: {t * 1e3:7.3f} ms/batch{TIMED_BATCH}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
