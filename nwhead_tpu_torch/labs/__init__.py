"""Kernel labs and the HBM yardstick, ported from the JAX package's
``scripts/`` and ``bench.py`` to PyTorch and CUDA.

Each module is the counterpart of the script of the same name and runs as
``python -m nwhead_tpu_torch.labs.<lab>`` (on the card by default, ``--device
cpu`` on request, ``--tiny`` for a small size):

* ``timing`` (``scripts/timing.py``, ``kernel_lab.interleaved_time``): cases
  timed in turns by CUDA events, L2 flushed, queued behind a spin kernel;
  ``paired_ratio`` (``bench.py:_paired_ratio``);
* ``stream`` (K13 ``bench.py:_stream_case``, L4 and L1 ``stream_reduce``):
  ``stream``, ``stream_reduce`` and ``stream_case`` on ``csrc/lab_stream.cu``;
* ``kernel_lab`` (L1): ``fused_variant`` on ``csrc/lab_nw.cu``;
* ``manual_pipe_lab`` (L3): ``manual_fused`` on ``csrc/lab_nw.cu``, K2's
  route of the forward's tensor-core pass 1 with the ring depth swept;
* ``prepared_lab``, ``roofline_lab`` (L4's users): K2 beside the stream;
* ``block_lab`` (L2): ``fused_blocks`` on ``csrc/lab_blocks.cu``;
* ``mlp_block_lab``, the port's own: K9, K11 and K11 int8 at ViT-S/14's and
  ViT-B/14's widths, for this checkout or another (``--tree``);
* ``attn_block_lab``, the port's own: K10 and K10 int8 the same way, with
  K10 int8's output SHA-256 at every fold and each call's device functions;
* ``build_diff``, the port's own: two checkouts' builds compared kernel by
  kernel, SASS and ``ptxas`` registers and spills.

Nothing here imports jax, the JAX package, ``scripts`` or ``bench.py``;
nothing is built or launched at import.
"""

import importlib

# Each lab kernel: the lab module that holds its counted CUDA wrapper, the
# wrapper, and the library (``csrc/<library>.cu``) the wrapper launches.
_KERNELS = {
    "stream": ("stream", "stream_cuda", "lab_stream"),
    "stream_reduce": ("stream", "stream_reduce_cuda", "lab_stream"),
    "fused_variant": ("kernel_lab", "fused_variant_cuda", "lab_nw"),
    "manual_fused": ("manual_pipe_lab", "manual_fused_cuda", "lab_nw"),
    "fused_blocks": ("block_lab", "fused_blocks_cuda", "lab_blocks"),
}
LAB_KERNELS = {kernel: library for kernel, (_, _, library) in _KERNELS.items()}


def lab_wrapper(kernel: str):
    """The counted CUDA wrapper of a lab kernel (its ``.launches``)."""
    module, wrapper, _ = _KERNELS[kernel]
    return getattr(importlib.import_module(f"{__name__}.{module}"), wrapper)
