"""Block lab: ResNet-18's layer1 (two BasicBlocks) as one inference kernel,
beside cuDNN, on the card.

Port of ``scripts/block_lab.py``. ``fused_blocks(x, w, b, n_blocks=2)``
runs ``n_blocks`` BasicBlocks with folded BatchNorm on NHWC bf16
activations ``(B, H, W, C)``, the JAX package's public layout: per block,
``h = bf16(relu(conv3x3(x, w1) + b1))`` and ``bf16(relu(conv3x3(h, w2) + b2 +
x))``, each conv 3x3 with zero padding 1 on bf16 weights, summed in f32,
plus an f32 bias. CUDA tensors run the kernel ``csrc/lab_blocks.cu`` (one
block per T x T output tile of an image, ``tile_plan``'s T, the halo
recomputed; each conv an implicit GEMM on the bf16 tensor cores, ``wgmma``
at C = 64 and ``mma.sync`` below; see there),
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
import math
import sys
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device
from nwhead_tpu_torch.ops import _cuda

Folded = Tuple[np.ndarray, np.ndarray]  # (w (3, 3, C_in, C_out) HWIO, b (C_out,))
TIMED_BATCH = 64  # the TPU lab's B
CHANNELS = (8, 16, 32, 64)
H100_SMEM_OPTIN = 232_448  # shared memory a block may opt in to on an H100 (sm_90)
H100_SMS = 132
# The kernel's constants (csrc/lab_blocks.cu): taps a conv, the weights'
# alignment slack, and who takes the tasks of m-tiles (16 output pixels):
# at C = 64 (wgmma) two warpgroups, four m-tiles a task; otherwise
# (mma.sync) eight warps, two m-tiles a task.
_TAPS, _ALIGN = 9, 1024
_WORKERS = {64: (2, 4)}
_WARP_TASKS = (8, 2)


class BlockPlan(NamedTuple):
    """A launch of ``fused_blocks``: output tiles of ``tile`` x ``tile``
    pixels; the block's shared memory: the region buffers X (side ``tile +
    4 n_blocks``) and H (two pixels less), a conv's nine taps of weights (C
    x C bf16 each) and 1 KB of slack that aligns them."""

    tile: int
    x_bytes: int
    h_bytes: int
    weight_bytes: int
    smem_bytes: int
    cost: int  # m-tiles on a block's critical path x waves of blocks


def _plan_for(B: int, H: int, W: int, C: int, n_blocks: int, tile: int, smem_optin: int,
              n_sms: int) -> Optional[BlockPlan]:
    """The plan at ``tile``, or None when its buffers and a conv's weights
    do not fit ``smem_optin``."""
    side = tile + 4 * n_blocks
    x_bytes, h_bytes = side * side * C * 2, (side - 2) ** 2 * C * 2
    weight_bytes = _TAPS * C * C * 2
    smem_bytes = _ALIGN + x_bytes + h_bytes + weight_bytes
    if smem_bytes > smem_optin:
        return None
    workers, task_mtiles = _WORKERS.get(C, _WARP_TASKS)
    rounds = 0
    for k in range(1, 2 * n_blocks + 1):  # conv k's output region has side side - 2k
        tasks = math.ceil(math.ceil((side - 2 * k) ** 2 / 16) / task_mtiles)
        rounds += math.ceil(tasks / workers) * task_mtiles
    waves = math.ceil(B * math.ceil(H / tile) * math.ceil(W / tile) / n_sms)
    return BlockPlan(tile, x_bytes, h_bytes, weight_bytes, smem_bytes, rounds * waves)


def tile_plan(B: int, H: int, W: int, C: int, n_blocks: int, *,
              smem_optin: int = H100_SMEM_OPTIN, n_sms: int = H100_SMS,
              tile: Optional[int] = None) -> BlockPlan:
    """The kernel's launch plan for a ``(B, H, W, C)`` input: the given
    ``tile``, or the T whose m-tiles on a block's critical path (rounds of
    tasks, each of all of K, summed over the convs) times the waves of
    blocks on ``n_sms`` SMs are fewest, the larger T on a tie: 14 at
    ResNet-18's layer1, (64, 56, 56, 64) with two blocks. Raises
    ``ValueError`` when no tile fits the block's shared memory."""
    if tile is not None:
        plan = _plan_for(B, H, W, C, n_blocks, tile, smem_optin, n_sms)
        if plan is None:
            raise ValueError(f"a {tile} x {tile} tile of {n_blocks} blocks at C={C} is beyond a "
                             f"block's {smem_optin} bytes of shared memory")
        return plan
    plans = [p for t in range(1, max(H, W) + 1)
             if (p := _plan_for(B, H, W, C, n_blocks, t, smem_optin, n_sms)) is not None]
    if not plans:
        raise ValueError(f"{n_blocks} blocks at C={C} are beyond a block's {smem_optin} bytes "
                         "of shared memory at any tile")
    return min(plans, key=lambda p: (p.cost, -p.tile))


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
    return (torch.from_numpy(w).to(torch.bfloat16).contiguous(),
            torch.from_numpy(b).contiguous())


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
                      n_blocks: int = 2, tile: Optional[int] = None) -> torch.Tensor:
    """Launch L2 ``fused_blocks`` (``csrc/lab_blocks.cu``) with
    ``tile_plan``'s tile, or the given ``tile`` (the lab's comparison)."""
    _check(x, w, b, n_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_blocks_cuda needs CUDA tensors, got {x.device}")
    B, H, W, C = x.shape
    if C not in CHANNELS:
        raise ValueError(f"fused_blocks_cuda takes C in 8, 16, 32, 64, got {C}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    for arg, t in (("weights", w), ("bias", b)):
        if t.device != x.device:
            raise ValueError(f"fused_blocks_cuda: {arg} on {t.device}, x on {x.device}")
    lib = _cuda.load_library("lab_blocks")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = tile_plan(B, H, W, C, n_blocks, smem_optin=lib.lab_blocks_smem_optin(dev),
                     n_sms=torch.cuda.get_device_properties(x.device).multi_processor_count,
                     tile=tile)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.lab_fused_blocks(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H,
                                  W, C, n_blocks, plan.tile,
                                  torch.cuda.current_stream(x.device).cuda_stream)
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
