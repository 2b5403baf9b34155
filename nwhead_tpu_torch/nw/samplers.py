"""Index-space episodic samplers (legacy-tree capability parity).

Port of ``nwhead_tpu/nw/samplers.py``, numpy as there, on the port's own
``nw/support.py:get_separated_indices``: for the same seed each sampler
yields the JAX package's indices in its order. The legacy tree builds
episodes at the *sampler* level (index space) rather than the loader level
(``legacy/data/sampler.py``). These are the equivalents, all yielding
numpy index arrays that the data layer gathers:

  * ``QuerySampler``              — shuffled singleton queries
    (``sampler.py:3-22``).
  * ``RandomSupportSampler``      — i.i.d. random support batches
    (``sampler.py:24-39``).
  * ``QuerySupportSampler``       — paired (query, episodic-support) streams
    (``sampler.py:41-67``).
  * ``SubsampleQuerySupportSampler`` — first subsample ``subsample_size``
    classes, then draw query + class-balanced support from them
    (``sampler.py:69-106``).
  * ``QuerySupportBatchSampler``  — batched queries + shared episodic
    support per batch (``sampler.py:108-148``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from nwhead_tpu_torch.nw.support import get_separated_indices


class QuerySampler:
    """Yields one query index at a time, shuffled each epoch."""

    def __init__(self, targets: Sequence[int], seed: Optional[int] = None):
        self.n = len(targets)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[int]:
        for i in self.rng.permutation(self.n):
            yield int(i)


class RandomSupportSampler:
    """Yields random support batches of ``n_support`` indices (with class
    coverage NOT guaranteed — the legacy random baseline)."""

    def __init__(
        self,
        targets: Sequence[int],
        n_support: int,
        num_batches: int,
        seed: Optional[int] = None,
    ):
        self.n = len(targets)
        self.n_support = n_support
        self.num_batches = num_batches
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[np.ndarray]:
        for _ in range(self.num_batches):
            yield self.rng.choice(self.n, size=self.n_support, replace=False)


class QuerySupportSampler:
    """Paired (query_index, support_indices) stream: every query gets a
    class-balanced support episode (``n_shot`` per class)."""

    def __init__(
        self,
        targets: Sequence[int],
        n_shot: int,
        seed: Optional[int] = None,
    ):
        self.targets = np.asarray(targets)
        self.per_class = [np.asarray(l) for l in get_separated_indices(targets)]
        self.n_shot = n_shot
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.targets)

    def _episode(self) -> np.ndarray:
        return np.concatenate(
            [self.rng.choice(row, size=self.n_shot, replace=False) for row in self.per_class]
        )

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        for q in self.rng.permutation(len(self.targets)):
            yield int(q), self._episode()


class SubsampleQuerySupportSampler:
    """Per step: subsample ``subsample_size`` classes, draw the query from
    one of them and a balanced support from all of them
    (``sampler.py:69-106``)."""

    def __init__(
        self,
        targets: Sequence[int],
        n_shot: int,
        subsample_size: int,
        num_batches: int,
        seed: Optional[int] = None,
    ):
        self.targets = np.asarray(targets)
        self.per_class = [np.asarray(l) for l in get_separated_indices(targets)]
        if subsample_size > len(self.per_class):
            raise ValueError(f"subsample_size={subsample_size} exceeds the "
                             f"{len(self.per_class)} classes")
        self.n_shot = n_shot
        self.subsample_size = subsample_size
        self.num_batches = num_batches
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        n_classes = len(self.per_class)
        for _ in range(self.num_batches):
            classes = self.rng.choice(n_classes, size=self.subsample_size, replace=False)
            qclass = int(self.rng.choice(classes))
            q = int(self.rng.choice(self.per_class[qclass]))
            support = np.concatenate([
                self.rng.choice(self.per_class[c], size=self.n_shot, replace=False)
                for c in classes
            ])
            yield q, support


class QuerySupportBatchSampler:
    """Batched queries with one shared class-balanced support per batch
    (``sampler.py:108-148``)."""

    def __init__(
        self,
        targets: Sequence[int],
        batch_size: int,
        n_shot: int,
        n_way: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.targets = np.asarray(targets)
        self.per_class = [np.asarray(l) for l in get_separated_indices(targets)]
        self.batch_size = batch_size
        self.n_shot = n_shot
        self.n_way = n_way
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.targets) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.targets))
        n_classes = len(self.per_class)
        stop = (len(order) // self.batch_size) * self.batch_size
        for start in range(0, stop, self.batch_size):
            qidx = order[start : start + self.batch_size]
            if self.n_way is not None:
                classes = self.rng.choice(n_classes, size=self.n_way, replace=False)
            else:
                classes = np.arange(n_classes)
            support = np.concatenate([
                self.rng.choice(self.per_class[c], size=self.n_shot, replace=False)
                for c in classes
            ])
            yield qidx, support
