"""The HBM yardstick: K13/L4 ``stream`` and L1 ``stream_reduce``.

Port of ``bench.py:_stream_case``'s ``stream`` (K13; the same kernel at
``scripts/prepared_lab.py``, ``scripts/roofline_lab.py`` and
``scripts/bigbank_lab.py``, L4) and ``scripts/kernel_lab.py:stream_reduce``
(L1). The three are one kernel, ``csrc/lab_stream.cu``, with two public
functions:

* ``stream(s)`` -> ``(8, D)``: over an ``(rows, D)`` f32 bank in tiles of
  2,048 rows, the sum of rows 0-7 of every tile;
* ``stream_reduce(s, block_s, touch_only=False)``: the sum of every row into
  ``(1, D)``, or with ``touch_only`` rows 0-7 of each ``block_s`` tile into
  ``(8, D)``.

Rows past the last whole tile are not read, as on the TPU. Its job is the
read rate, so the kernel reads every byte of every tile in both modes (see
the source). A bank that fits the card's 50 MB L2 (the bench's 12,288 x 512
f32, 25.2 MB) reads from HBM only when the L2 is flushed before the call
(``timing.interleaved_time`` does), or when it is sized above the L2 (the
bench's 196,608 rows, 403 MB).

A CPU tensor goes to the plain version (``_stream_plain``,
``_stream_reduce_plain``: ``torch.sum`` of each tile, added in tile order), a
CUDA tensor to the kernel; there is no fallback between them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops import _cuda

STREAM_BLOCK_S = 2048  # bench.py's tile: the TPU DMA'd whole (2048, D) tiles
TOUCH_ROWS = 8
CHUNK_BYTES = 16 << 10  # a pass-1 chunk: 8 rows of D = 512
BLOCKS_PER_SM = 4


def _stream_reduce_plain(s: torch.Tensor, block_s: int, touch_only: bool = False) -> torch.Tensor:
    """L1 ``stream_reduce`` in plain PyTorch: per tile, the sum of its rows
    (``(1, D)``) or its rows 0-7 (``(8, D)``), added in tile order."""
    n_tiles = s.shape[0] // block_s
    if n_tiles < 1:
        raise ValueError(f"{s.shape[0]} rows hold no whole tile of {block_s}")
    rows = TOUCH_ROWS if touch_only else 1
    acc = torch.zeros((rows, s.shape[1]), dtype=torch.float32, device=s.device)
    for t in range(n_tiles):
        tile = s[t * block_s:(t + 1) * block_s].to(torch.float32)
        acc += tile[:TOUCH_ROWS] if touch_only else torch.sum(tile, dim=0, keepdim=True)
    return acc


def _stream_plain(s: torch.Tensor) -> torch.Tensor:
    """K13 ``stream`` in plain PyTorch."""
    return _stream_reduce_plain(s, STREAM_BLOCK_S, True)


def plain_agreement(got: torch.Tensor, s: torch.Tensor, block_s: int,
                    touch_only: bool) -> Tuple[bool, float]:
    """Whether ``got``, a reduce of ``s`` at ``(block_s, touch_only)``, is
    finite and within 1e-5 of the plain version's sum of ``|s|`` (the sums'
    own scale), and its max|err| against the plain version."""
    want = _stream_reduce_plain(s, block_s, touch_only)
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= 1e-5 * _stream_reduce_plain(s.abs(), block_s, touch_only)).all())
    return ok, float(diff.max())


def _chunk_rows(block_s: int, D: int, max_bytes: int) -> int:
    """Rows of a pass-1 chunk: a power-of-two multiple of 8 that divides
    ``block_s``, up to ``CHUNK_BYTES``."""
    if block_s % TOUCH_ROWS or D % 4:
        raise ValueError(f"the stream kernel takes block_s a multiple of 8 and D a multiple "
                         f"of 4, got block_s={block_s}, D={D}")
    rows = TOUCH_ROWS
    if rows * D * 4 > max_bytes:
        raise ValueError(f"D={D} is beyond the stream kernel's chunk ({max_bytes} bytes)")
    while (2 * rows * D * 4 <= CHUNK_BYTES and block_s % (2 * rows) == 0):
        rows *= 2
    return rows


def _chunks_per_block(n_tiles: int, chunks_per_tile: int, n_sms: int) -> int:
    """Chunks a block streams: about ``BLOCKS_PER_SM`` blocks a SM, a
    divisor of the chunks in a tile."""
    cpb = max(1, n_tiles * chunks_per_tile // (BLOCKS_PER_SM * n_sms))
    cpb = min(cpb, chunks_per_tile)
    while chunks_per_tile % cpb:
        cpb -= 1
    return cpb


def _stream_launch(name: str, s: torch.Tensor, block_s: int, touch_only: bool) -> torch.Tensor:
    """Check the operands and launch the two passes on the current stream."""
    if s.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {s.device}")
    if s.dtype != torch.float32 or s.dim() != 2 or not s.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (rows, D) f32 bank, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if s.shape[0] < block_s or block_s < TOUCH_ROWS:
        raise ValueError(f"{s.shape[0]} rows hold no whole tile of {block_s}")
    if s.data_ptr() % 16:
        raise ValueError(f"{name}: the bank must start on a 16-byte boundary")
    lib = _cuda.load_library("lab_stream")
    D, n_tiles = s.shape[1], s.shape[0] // block_s
    chunk_rows = _chunk_rows(block_s, D, lib.lab_stream_max_chunk_bytes())
    n_sms = torch.cuda.get_device_properties(s.device).multi_processor_count
    cpb = _chunks_per_block(n_tiles, block_s // chunk_rows, n_sms)
    n_blocks = n_tiles * (block_s // chunk_rows) // cpb
    f32 = dict(dtype=torch.float32, device=s.device)
    partial = torch.empty((n_tiles, TOUCH_ROWS, D) if touch_only else (n_blocks, D), **f32)
    out = torch.empty((TOUCH_ROWS if touch_only else 1, D), **f32)
    with torch.cuda.device(s.device):
        rc = lib.lab_stream_reduce(s.data_ptr(), partial.data_ptr(), out.data_ptr(), n_tiles,
                                   block_s, D, chunk_rows, cpb, int(touch_only),
                                   torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.lab_stream_error_string(rc).decode()}")
    return out


def stream_cuda(s: torch.Tensor) -> torch.Tensor:
    """Launch K13 (``csrc/lab_stream.cu``, touch_only at 2,048-row tiles)."""
    out = _stream_launch("stream_cuda", s, STREAM_BLOCK_S, True)
    stream_cuda.launches += 1
    return out


stream_cuda.launches = 0


def stream_reduce_cuda(s: torch.Tensor, block_s: int, touch_only: bool = False) -> torch.Tensor:
    """Launch L1 ``stream_reduce`` (``csrc/lab_stream.cu``)."""
    out = _stream_launch("stream_reduce_cuda", s, block_s, touch_only)
    stream_reduce_cuda.launches += 1
    return out


stream_reduce_cuda.launches = 0


def stream(s: torch.Tensor) -> torch.Tensor:
    """K13: the sum of rows 0-7 of each 2,048-row tile of ``s``, ``(8, D)``
    f32; every byte of every tile is read (see the module docstring)."""
    if s.device.type == "cpu":
        return _stream_plain(s)
    return stream_cuda(s)


def stream_reduce(s: torch.Tensor, block_s: int, touch_only: bool = False) -> torch.Tensor:
    """L1: the sum of every row of ``s``'s ``block_s`` tiles, ``(1, D)``, or
    with ``touch_only`` of rows 0-7 of each, ``(8, D)``."""
    if s.device.type == "cpu":
        return _stream_reduce_plain(s, block_s, touch_only)
    return stream_reduce_cuda(s, block_s, touch_only)


def stream_case(rng: np.random.Generator, D: int = 512, rows: int = 12288,
                device="cuda"):
    """``bench.py:_stream_case``: ``(("stream", fn, (s,)), n_bytes)`` with
    ``s`` drawn from ``rng`` as the bench draws it and ``fn(s) =
    stream(s).mean()``. ``rows`` sizes the bank: 12,288 (25.2 MB, in the
    L2 unless flushed) or the bigbank loop's 196,608 (403 MB)."""
    s_big = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).to(device)

    def fn(s):
        return stream(s).mean()

    return ("stream", fn, (s_big,)), s_big.numel() * 4


def stream_bytes(s: torch.Tensor, block_s: int = STREAM_BLOCK_S) -> int:
    """The bytes a stream over ``s`` reads: its whole tiles."""
    return (s.shape[0] // block_s) * block_s * s.shape[1] * s.element_size()
