"""Serving utilities of the port: ``batching`` (``MicroBatcher``), ``httpd``
(``NWHttpServer``, ``ServingStats``) and ``pipeline`` (the three-stage
decode / copy / compute pipeline and the JPEG sources of the serve CLI's
``--jpeg_bench``), ports of the JAX package's ``nwhead_tpu/utils``; and
``linear_normalization``, its display rescale. Nothing here imports jax,
and importing a module starts no thread and opens no socket."""

from __future__ import annotations

import numpy as np


def linear_normalization(arr: np.ndarray, new_range=(0, 1)) -> np.ndarray:
    """Per-image min/max rescale for display (the reference's
    ``nwhead/utils.py:161-176``, JAX ``utils/__init__.py``): ``arr (B, H,
    W, C)`` NHWC, each image's channels mapped from ``[min, max]`` to
    ``new_range`` (a channel whose max is 0 divides by ``1 - min``)."""
    arr = np.asarray(arr, dtype=np.float32)
    bs = arr.shape[0]
    flat = arr.reshape(bs, -1, arr.shape[-1])
    mx = flat.max(axis=1)[:, None, None, :]
    mn = flat.min(axis=1)[:, None, None, :]
    mx = np.where(mx == 0, 1.0, mx)
    lo, hi = new_range
    return (arr - mn) * (hi - lo) / (mx - mn) + lo
