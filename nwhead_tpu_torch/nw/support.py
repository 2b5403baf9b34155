"""Support-set index math for the full-mode bank.

Port of the full-bank part of ``nwhead_tpu/nw/support.py``: the label
buckets, the class-balanced ``FullDataset`` bank indices, the environment
bookkeeping, and ``SupportSetEval`` holding the full bank. Numpy, as in the
JAX package, so the same indices come out. The other eval modes (random,
cluster, ensemble, knn, hnsw) and the episodic samplers are later slices
(ROADMAP.md queue 1, items 5 and 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


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


class SupportSetEval:
    """Inference-time support artifacts, full mode: per-environment balanced
    bank indices, and the featurized bank once ``build_infer_iters`` ran."""

    def __init__(
        self,
        targets_or_list,
        n_classes: int,
        n_shot_full: int = 100,
        env_array: Optional[Sequence[int]] = None,
    ) -> None:
        self.envs = Environments.build(targets_or_list, env_array)
        self.n_classes = n_classes
        self.n_shot_full = n_shot_full
        self.full_bank_indices: List[np.ndarray] = []
        for e in self.envs.env_ids:
            idx = self.envs.env_indices(e)
            local = balanced_full_indices(self.envs.targets[idx], n_shot_full)
            self.full_bank_indices.append(idx[local])

    def build_infer_iters(self, sfeat: torch.Tensor, sy: np.ndarray) -> None:
        """Install the featurized full bank (rows in the order of the
        concatenated ``full_bank_indices``); ``sfeat`` stays on its device."""
        self.full_feat = sfeat
        self.full_y = torch.as_tensor(np.asarray(sy), dtype=torch.int64, device=sfeat.device)

    def get_support(self, mode: str):
        """Support features and labels for an inference mode."""
        if mode != "full":
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet (ROADMAP.md queue 1, item 8)"
            )
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        return self.full_feat, self.full_y
