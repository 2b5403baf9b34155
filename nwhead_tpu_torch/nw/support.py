"""Support-set engine: episodic sampling, balanced full banks, environments.

Port of ``nwhead_tpu/nw/support.py``: the label buckets, the class-balanced
``FullDataset`` bank indices, the environment bookkeeping, the episodic
sampler, ``SupportSetTrain`` (random and IRM episodes) and
``SupportSetEval`` with the full bank, the random mode's sampler over it
and the cluster mode's per-class k-means bank (``ops/kmeans.py``). Numpy,
as in the JAX package, with the same seeding chain, so the same indices
come out in the same order. The ensemble, knn and hnsw eval modes are a
later slice (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops.kmeans import compute_clusters


def get_separated_indices(vals: Sequence[int]) -> List[List[int]]:
    """Bucket indices per label, mapping labels to consecutive ids:
    ``[0, 1, 1, 2, 3] -> [[0], [1, 2], [3], [4]]``."""
    vals = np.asarray(vals)
    uniq = sorted(set(vals.tolist()))
    remap = {y: i for i, y in enumerate(uniq)}
    indices: List[List[int]] = [[] for _ in uniq]
    for i, c in enumerate(vals.tolist()):
        indices[remap[c]].append(i)
    return indices


def balanced_full_indices(targets: Sequence[int], n_shot_full: int) -> np.ndarray:
    """Class-balanced full-mode bank: the first ``min(n_shot_full,
    smallest class count)`` indices of each class."""
    per_class = get_separated_indices(targets)
    n = min(n_shot_full, min(len(l) for l in per_class))
    keys: List[int] = []
    for l in per_class:
        keys += l[:n]
    return np.asarray(keys, dtype=np.int64)


class EpisodicSampler:
    """Uniform-class episodic support sampler (the reference's
    ``InfiniteUniformClassLoader.next(qy)``), in index space.

    With ``n_way`` set, an episode holds every query class plus
    ``n_way - len(qy)`` other classes drawn uniformly without the query
    classes, ``n_shot`` items per class without replacement; without
    ``n_way`` it takes every class. The order is the JAX package's: the
    drawn classes first, then the query classes."""

    def __init__(self, targets: Sequence[int], n_shot: int, n_way: Optional[int] = None,
                 seed: Optional[int] = None) -> None:
        self.indices = [np.asarray(l) for l in get_separated_indices(targets)]
        self.n_classes = len(self.indices)
        self.n_shot = n_shot
        self.n_way = n_way
        if n_way and n_way > self.n_classes:
            raise ValueError(f"n_way={n_way} exceeds the {self.n_classes} classes")
        self.rng = np.random.default_rng(seed)
        uniq = sorted(set(np.asarray(targets).tolist()))
        self._label_of_class = np.asarray(uniq)
        total = sum(len(l) for l in self.indices)
        self._class_of_index = np.empty(total, dtype=np.int64)
        for c, l in enumerate(self.indices):
            self._class_of_index[l] = c

    def sample(self, qy: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One episode: ``(support_indices, support_labels)``."""
        if self.n_way:
            if qy is None:
                raise ValueError("n_way sampling needs the query labels")
            qy = np.asarray(qy)
            if len(qy) > self.n_way:
                raise ValueError(f"{len(qy)} query labels for n_way={self.n_way}")
            n_extra = self.n_way - len(qy)
            if n_extra > 0:
                probs = np.ones(self.n_classes)
                probs[qy] = 0
                total = probs.sum()
                if total == 0:
                    # Every class is a query class already: uniform over all.
                    probs[:] = 1.0 / self.n_classes
                else:
                    probs /= total
                subclasses = self.rng.choice(self.n_classes, size=n_extra, replace=False, p=probs)
            else:
                subclasses = np.empty(0, dtype=np.int64)
            class_rows = [self.indices[i] for i in np.concatenate([subclasses, qy])]
        else:
            class_rows = self.indices
        support_idxs = np.stack(
            [self.rng.choice(row, size=self.n_shot, replace=False) for row in class_rows]
        ).flatten()
        return support_idxs, self._label_of_class[self._class_of_index[support_idxs]]


@dataclass
class Environments:
    """Environment info for a support dataset, from (a) targets plus an env
    array, (b) a list of per-environment target arrays, or (c) targets
    alone (one environment, id 0)."""

    targets: np.ndarray
    env_array: np.ndarray
    env_ids: np.ndarray

    @staticmethod
    def build(targets_or_list, env_array: Optional[Sequence[int]] = None) -> "Environments":
        if env_array is not None:
            targets = np.asarray(targets_or_list)
            env_array = np.asarray(env_array)
            if len(env_array) != len(targets):
                raise ValueError(f"{len(env_array)} env ids for {len(targets)} targets")
        elif isinstance(targets_or_list, (list, tuple)) and not np.isscalar(targets_or_list[0]):
            parts = [np.asarray(t) for t in targets_or_list]
            targets = np.concatenate(parts)
            env_array = np.concatenate(
                [np.full(len(p), i, dtype=np.int64) for i, p in enumerate(parts)]
            )
        else:
            targets = np.asarray(targets_or_list)
            env_array = np.zeros(len(targets), dtype=np.int64)
        return Environments(targets=targets, env_array=np.asarray(env_array),
                            env_ids=np.unique(env_array))

    @property
    def n_envs(self) -> int:
        return len(self.env_ids)

    def env_indices(self, env_id) -> np.ndarray:
        return np.nonzero(self.env_array == env_id)[0]


class SupportSetTrain:
    """Training-time support sampling. ``train_type='random'``: one
    episodic sampler over the whole dataset, conditioned on the query
    labels. ``'irm'``: one sampler per environment, and each step draws its
    whole support from one environment picked uniformly. Every sampler's
    seed is drawn from this object's own generator, in the JAX package's
    order."""

    def __init__(
        self,
        targets_or_list,
        n_classes: int,
        train_type: str = "random",
        n_shot: int = 1,
        n_way: Optional[int] = None,
        env_array: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.envs = Environments.build(targets_or_list, env_array)
        self.n_classes = n_classes
        self.train_type = train_type
        self.n_shot = n_shot
        self.n_way = n_way
        self._rng = np.random.default_rng(seed)
        self.sampler: Optional[EpisodicSampler] = None
        self._env_samplers: List[EpisodicSampler] = []
        self._env_index_maps: List[np.ndarray] = []
        if train_type == "random":
            self.sampler = EpisodicSampler(self.envs.targets, n_shot, n_way, seed=self._seed())
        elif train_type == "irm":
            for e in self.envs.env_ids:
                idx = self.envs.env_indices(e)
                self._env_samplers.append(
                    EpisodicSampler(self.envs.targets[idx], n_shot, seed=self._seed()))
                self._env_index_maps.append(idx)
        else:
            raise ValueError(f"train_type must be 'random' or 'irm', got {train_type}")

    def _seed(self) -> int:
        return int(self._rng.integers(0, 2**31 - 1))

    def _samplers(self) -> List[EpisodicSampler]:
        return self._env_samplers if self.train_type == "irm" else [self.sampler]

    def rng_state(self) -> dict:
        """JSON-able state of every generator (the environment picker and
        each sampler's), so a resumed run draws the same episodes."""
        return {"outer": self._rng.bit_generator.state,
                "samplers": [s.rng.bit_generator.state for s in self._samplers()]}

    def set_rng_state(self, state: dict) -> None:
        samplers = self._samplers()
        if len(state["samplers"]) != len(samplers):
            raise ValueError(f"sampler-state count mismatch: checkpoint has "
                             f"{len(state['samplers'])}, this run has {len(samplers)}")
        self._rng.bit_generator.state = state["outer"]
        for s, st in zip(samplers, state["samplers"]):
            s.rng.bit_generator.state = st

    def support_size(self) -> int:
        """Rows per episode (the same on every step)."""
        if self.train_type == "irm":
            return self.n_classes * self.n_shot
        return (self.n_way or self.n_classes) * self.n_shot

    def get_support(self, qy: Optional[np.ndarray] = None):
        """One episode: ``(dataset_indices, labels, environment per row)``."""
        if self.train_type == "irm":
            e = int(self._rng.integers(0, self.envs.n_envs))
            local_idx, labels = self._env_samplers[e].sample()
            idx = self._env_index_maps[e][local_idx]
            return idx, labels, np.full(len(idx), self.envs.env_ids[e])
        idx, labels = self.sampler.sample(qy)
        return idx, labels, self.envs.env_array[idx]


class SupportSetEval:
    """Inference-time support artifacts: per-environment balanced bank
    indices, and once ``build_infer_iters`` ran, the featurized full bank,
    the random mode's episodic sampler over it (rebuilt from ``seed`` at
    every ``build_infer_iters``, as the JAX package does) and the cluster
    bank: ``n_shot_cluster`` k-means centroids per class of the full bank
    (``cluster_impl`` ``"device"``, on the bank's device, or ``"sklearn"``,
    the reference's host fit, bit-identical with the JAX package's)."""

    def __init__(
        self,
        targets_or_list,
        n_classes: int,
        n_shot_random: int = 1,
        n_shot_full: int = 100,
        n_shot_cluster: int = 3,
        env_array: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        cluster_impl: str = "device",
    ) -> None:
        self.envs = Environments.build(targets_or_list, env_array)
        self.n_classes = n_classes
        self.n_shot_random = n_shot_random
        self.n_shot_full = n_shot_full
        self.n_shot_cluster = n_shot_cluster
        self.seed = seed
        self.cluster_impl = cluster_impl
        self.full_bank_indices: List[np.ndarray] = []
        for e in self.envs.env_ids:
            idx = self.envs.env_indices(e)
            local = balanced_full_indices(self.envs.targets[idx], n_shot_full)
            self.full_bank_indices.append(idx[local])

    def build_infer_iters(self, sfeat: torch.Tensor, sy: np.ndarray) -> None:
        """Install the featurized full bank (rows in the order of the
        concatenated ``full_bank_indices``; ``sfeat`` stays on its device)
        and build the cluster bank from it (k-means seed 0, as the JAX
        package). Under a mesh this is the whole bank, before it is
        sharded."""
        self.full_feat = sfeat
        self._full_y_np = np.asarray(sy)
        self.full_y = torch.as_tensor(self._full_y_np, dtype=torch.int64, device=sfeat.device)
        self.cluster_feat, self.cluster_y = compute_clusters(
            sfeat, self._full_y_np, self.n_shot_cluster, impl=self.cluster_impl)
        self.random_sampler = EpisodicSampler(self._full_y_np, self.n_shot_random, seed=self.seed)

    def get_support(self, mode: str):
        """Support features and labels for an inference mode."""
        if mode not in ("random", "full", "cluster"):
            raise NotImplementedError(
                f"mode {mode!r} has no support set here: knn, hnsw and ensemble are "
                "ROADMAP.md queue 1, item 6; ivf is NWNet.predict(mode='ivf')"
            )
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        if mode == "random":
            idx, _ = self.random_sampler.sample()
            idx_t = torch.as_tensor(idx, device=self.full_feat.device)
            return self.full_feat[idx_t], self.full_y[idx_t]
        if mode == "cluster":
            return self.cluster_feat, self.cluster_y
        return self.full_feat, self.full_y
