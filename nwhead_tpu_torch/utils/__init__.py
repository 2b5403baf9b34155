"""Utilities of the port: ``batching`` (``MicroBatcher``), ``httpd``
(``NWHttpServer``, ``ServingStats``), ``pipeline`` (the three-stage
decode / copy / compute pipeline and the JPEG sources of the serve CLI's
``--jpeg_bench``), ``aot`` (the serving artifacts) and ``profiling``
(``trace``, ``annotate``, ``StepTimer``), ports of the JAX package's
``nwhead_tpu/utils``; and, from its ``__init__``, ``summary`` (the model
summary) and ``linear_normalization`` (its display rescale). Nothing here
imports jax, and importing a module starts no thread and opens no socket."""

from __future__ import annotations

import numpy as np
from torch import nn


def summary(module: nn.Module) -> int:
    """Print the module, every trainable parameter's name and shape and the
    total, between JAX's banner lines (the reference's ``util/utils.py:
    13-29``); returns the count. JAX's ``summary(module, variables)`` reads
    the parameters from its separate variables; a torch module holds its
    own, so it takes the module alone (and counts only parameters that
    require grad)."""
    print()
    print("Model Summary")
    print("---------------------------------------------------------------")
    print(module)
    print("---------------------------------------------------------------")
    print("Trainable parameters:")
    total = 0
    for name, p in module.named_parameters():
        if p.requires_grad:
            print(name, tuple(p.shape))
            total += p.numel()
    print()
    print("Total parameters:", total)
    print("---------------------------------------------------------------")
    print()
    return total


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
