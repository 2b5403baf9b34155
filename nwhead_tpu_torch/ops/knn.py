"""Exact k-nearest-neighbour support construction (the knn eval mode).

Port of ``nwhead_tpu/ops/knn.py``: squared-L2 distances by
``kernels.pairwise_sqdist`` in f32 (never TF32), then the k nearest bank
rows of each query. The JAX package takes them with ``lax.top_k``, which
breaks ties by the lowest index; ``torch.topk`` gives no order among equal
values, so the port takes the k smallest by a stable sort, which keeps the
lowest index first. No TPU kernel is involved: JAX computes the distance
matrix in XLA.

``ExactKNN(x)`` returns the flat union of the batch's neighbour sets,
``(B * k, D)`` features and ``(B * k,)`` labels, duplicates included, which
the NW head then shares across the whole batch: the reference's ``KNN``
quirk (``nwhead/utils.py:178-193``), kept as the JAX package keeps it.

Everything stays on the bank's device: the search, the ids and the gather.
The JAX package's ``host=True`` numpy search serves its mesh nets, which
keep the bank on the host; the port's mesh nets keep it on their device, so
it has no host path.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple

import torch

from nwhead_tpu_torch.ops.kernels import pairwise_sqdist


@contextmanager
def f32_products():
    """cuBLAS f32 products without TF32 for the block (TF32 would move the
    distances by about three decimal digits and reorder neighbours)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _check_k(k: int, rows: int, what: str) -> None:
    if not 1 <= k <= rows:
        raise ValueError(f"k={k} neighbours out of a {what} of {rows} rows "
                         "(lax.top_k refuses k larger than its input)")


def _k_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row and their positions, ties by the lowest
    position (a stable ascending sort)."""
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def knn_indices(x: torch.Tensor, bank: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``(B, k)`` int64 of the k nearest bank rows of each query
    ``x (B, D)`` (exact, squared L2), nearest first; among equal distances
    the lower index first."""
    _check_k(k, bank.shape[0], "bank")
    with f32_products():
        d2 = pairwise_sqdist(x.to(torch.float32), bank.to(torch.float32))
    return _k_smallest(d2, k)[1]


@torch.no_grad()
def knn_indices_chunked(x: torch.Tensor, bank: torch.Tensor, k: int,
                        chunk: int = 65536) -> torch.Tensor:
    """``knn_indices`` over banks too large for a ``(B, S)`` distance matrix:
    the bank in chunks of ``chunk`` rows (``S`` a multiple of it, as the JAX
    package requires), each chunk's k nearest merged into a running best.
    The carried best sits before the chunk's, and its indices are lower, so
    ties go to the lowest index as in one sort over the whole bank."""
    S = bank.shape[0]
    if S % chunk:
        raise ValueError(f"pad the bank to a chunk multiple: {S} rows, chunk {chunk}")
    _check_k(k, chunk, "chunk")
    best_d = best_i = None
    with f32_products():
        for start in range(0, S, chunk):
            d2 = pairwise_sqdist(x.to(torch.float32),
                                 bank[start:start + chunk].to(torch.float32))
            d, i = _k_smallest(d2, k)
            i = i + start
            if best_d is not None:
                d, pos = _k_smallest(torch.cat([best_d, d], dim=1), k)
                i = torch.gather(torch.cat([best_i, i], dim=1), 1, pos)
            best_d, best_i = d, i
    return best_i


class ExactKNN:
    """The reference's ``KNN`` interface: ``knn(x) -> (support features
    (B * k, D), support labels (B * k,))`` over a bank ``data (S, D)`` with
    ``labels (S,)``, both kept on the bank's device."""

    def __init__(self, data: torch.Tensor, labels: torch.Tensor, n_neighbors: int = 20) -> None:
        self.data = data
        self.labels = torch.as_tensor(labels, device=data.device)
        self.n_neighbors = n_neighbors

    def indices(self, x: torch.Tensor) -> torch.Tensor:
        """The neighbours' bank rows ``(B, k)`` of queries ``x (B, D)``."""
        return knn_indices(torch.as_tensor(x).to(self.data.device), self.data,
                           self.n_neighbors)

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = self.indices(x).reshape(-1)  # the flat union (utils.py:191-192)
        return self.data[flat], self.labels[flat]
