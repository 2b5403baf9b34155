"""Support-set engine: episodic sampling, balanced full banks, environments.

Port of ``nwhead_tpu/nw/support.py``: the label buckets, the class-balanced
``FullDataset`` bank indices, the environment bookkeeping, the episodic
sampler, ``SupportSetTrain`` (random and IRM episodes) and
``SupportSetEval`` with the support of every inference mode: the full bank,
the random mode's sampler over it, the cluster mode's per-class k-means
bank (``ops/kmeans.py``), the ensemble mode's per-environment banks
stacked and masked, and the knn and hnsw modes' neighbour unions
(``ops/knn.py``, ``native/hnsw.py``). Numpy, as in the JAX package, with the
same seeding chain, so the same indices come out in the same order.

``SupportSetEval`` also edits its installed bank in place of a new
featurizer pass: ``extend_bank`` appends rows to an environment (or adds
one), ``remove_bank_items`` drops rows. Each builds the bank anew on its
device from the rows it keeps (one copy of the bank, no read back to the
host) and rebuilds what depends on the whole bank: the cluster bank (a
k-means over every row), the random sampler and the exact k-NN search.
An HNSW graph already built grows by online insertion; a removal drops it
and the next hnsw use builds it again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops.kmeans import compute_clusters
from nwhead_tpu_torch.ops.knn import ExactKNN


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
    indices, and once ``build_infer_iters`` ran, the featurized full bank
    with its per-environment parts, and from it the random mode's episodic
    sampler (rebuilt from ``seed`` at every ``build_infer_iters``, as the JAX
    package does), the cluster bank (``n_shot_cluster`` k-means centroids per
    class, ``cluster_impl`` ``"device"``, on the bank's device, or
    ``"sklearn"``, the reference's host fit, bit-identical with the JAX
    package's), the ensemble mode's stacked environment banks (built at its
    first use: they copy the bank), the exact k-NN search and the HNSW index
    (``n_neighbors`` a query; the graph is built at the first hnsw use, from
    the installed bank, where the JAX package builds it at every
    ``build_infer_iters``: a bank that no hnsw call reads, such as every
    training eval's and serving's, pays nothing for it)."""

    def __init__(
        self,
        targets_or_list,
        n_classes: int,
        n_shot_random: int = 1,
        n_shot_full: int = 100,
        n_shot_cluster: int = 3,
        n_neighbors: int = 20,
        env_array: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        cluster_impl: str = "device",
    ) -> None:
        self.envs = Environments.build(targets_or_list, env_array)
        self.n_classes = n_classes
        self.n_shot_random = n_shot_random
        self.n_shot_full = n_shot_full
        self.n_shot_cluster = n_shot_cluster
        self.n_neighbors = n_neighbors
        self.seed = seed
        self.cluster_impl = cluster_impl
        self.full_bank_indices: List[np.ndarray] = []
        for e in self.envs.env_ids:
            idx = self.envs.env_indices(e)
            local = balanced_full_indices(self.envs.targets[idx], n_shot_full)
            self.full_bank_indices.append(idx[local])

    def build_infer_iters(
        self,
        sfeat: torch.Tensor,
        sy: np.ndarray,
        smeta: Optional[np.ndarray] = None,
        sfeat_env: Optional[Sequence[torch.Tensor]] = None,
        sy_env: Optional[Sequence[np.ndarray]] = None,
        smeta_env: Optional[Sequence[np.ndarray]] = None,
    ) -> None:
        """Install the featurized full bank (rows in the order of the
        concatenated ``full_bank_indices``; ``sfeat`` stays on its device),
        each row's environment ``smeta``, and the same bank split by
        environment (``sfeat_env``, ``sy_env``, ``smeta_env``; views of
        ``sfeat`` serve), then build the artifacts that need the whole bank:
        the cluster bank (k-means seed 0, as the JAX package), the random
        mode's sampler and the exact k-NN search. Without the environment
        lists the bank is one environment, id 0. Under a mesh this is the
        whole bank, before it is sharded. ``bank_is_canonical`` says that
        row ``i`` is still the ``i``-th of ``full_bank_indices``; an edit
        clears it."""
        if sfeat_env is None:
            smeta = np.zeros(len(sy), np.int64) if smeta is None else smeta
            sfeat_env, sy_env, smeta_env = [sfeat], [sy], [smeta]
        self._install_bank(sfeat, sy, smeta, sfeat_env, sy_env, smeta_env)
        self.bank_is_canonical = True

    def _install_bank(self, sfeat, sy, smeta, sfeat_env, sy_env, smeta_env, hnsw=None) -> None:
        """Build the artifacts of a bank, then install it with them: a build
        that fails leaves the installed bank as it was."""
        full_y_np = np.asarray(sy)
        full_y = torch.as_tensor(full_y_np, dtype=torch.int64, device=sfeat.device)
        clusters = compute_clusters(sfeat, full_y_np, self.n_shot_cluster, impl=self.cluster_impl)
        sampler = EpisodicSampler(full_y_np, self.n_shot_random, seed=self.seed)
        self.full_feat, self._full_y_np, self.full_y = sfeat, full_y_np, full_y
        self.full_meta = np.asarray(smeta)
        self.full_feat_sep = list(sfeat_env)
        self.full_y_sep = [np.asarray(y) for y in sy_env]
        self.full_meta_sep = [np.asarray(m) for m in smeta_env]
        self._ensemble_cache = None
        self._hnsw = hnsw
        self.cluster_feat, self.cluster_y = clusters
        self.random_sampler = sampler
        self.knn = ExactKNN(sfeat, full_y, self.n_neighbors)

    def extend_bank(self, new_feat: torch.Tensor, new_y, env_id: int = 0) -> None:
        """Append featurized rows to environment ``env_id``, at the end of
        its segment (a new id appends an environment), and rebuild the
        artifacts over the grown bank (``support.py:350``). An HNSW graph
        that was built grows by ``add_items`` once the install succeeded,
        so a failed install leaves it matching the bank still installed;
        one not yet built stays unbuilt."""
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        new_feat = torch.as_tensor(new_feat).to(self.full_feat.device, self.full_feat.dtype)
        new_y = np.asarray(new_y)
        if len(new_feat) != len(new_y):
            raise ValueError(f"{len(new_feat)} features vs {len(new_y)} labels")
        pieces = [[f] for f in self.full_feat_sep]
        ys, metas = list(self.full_y_sep), list(self.full_meta_sep)
        env_order = [int(m[0]) for m in metas]
        new_meta = np.full(len(new_y), env_id, dtype=np.int64)
        if env_id in env_order:
            e = env_order.index(env_id)
            pieces[e].append(new_feat)
            ys[e] = np.concatenate([ys[e], new_y])
            metas[e] = np.concatenate([metas[e], new_meta])
        else:
            pieces.append([new_feat])
            ys.append(new_y)
            metas.append(new_meta)
        full = torch.cat([f for env in pieces for f in env])
        hnsw = self._hnsw
        self._install_bank(full, np.concatenate(ys), np.concatenate(metas),
                           full.split([len(y) for y in ys]), ys, metas, hnsw=hnsw)
        if hnsw is not None:
            hnsw.add_items(new_feat, new_y)
        self.bank_is_canonical = False

    def remove_bank_items(self, indices) -> None:
        """Drop rows (indices into the current bank order) and rebuild the
        artifacts over the rows kept (``support.py:393``), gathered on the
        bank's device. An environment left empty is dropped (an all-masked
        environment would give the ensemble NaN); so is the HNSW graph,
        which has no deletion. Out-of-range indices raise ``IndexError``,
        removing every row ``ValueError``."""
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        n = len(self._full_y_np)
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"indices out of range for bank of {n}")
        keep = np.ones(n, dtype=bool)
        keep[idx] = False
        if not keep.any():
            raise ValueError("cannot remove every support item: an empty bank has no valid "
                             "predictions; swap the support set instead")
        # The bank is environment-contiguous, and so are the rows it keeps.
        kept = self.full_feat[torch.as_tensor(np.nonzero(keep)[0], device=self.full_feat.device)]
        ys, metas = [], []
        rest = keep
        for y, m in zip(self.full_y_sep, self.full_meta_sep):
            sel, rest = rest[:len(y)], rest[len(y):]
            if sel.any():
                ys.append(y[sel])
                metas.append(m[sel])
        self._install_bank(kept, np.concatenate(ys), np.concatenate(metas),
                           kept.split([len(y) for y in ys]), ys, metas)
        self.bank_is_canonical = False

    @property
    def hnsw(self):
        """The HNSW index over the installed bank (``native/hnsw.py``), built
        at its first use; a build that fails raises."""
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        if self._hnsw is None:
            from nwhead_tpu_torch.native.hnsw import HNSWIndex

            self._hnsw = HNSWIndex(self.full_feat, self.full_y, self.n_neighbors)
        return self._hnsw

    def _ensemble_banks(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The environments' banks padded to the longest and stacked on the
        bank's device: ``(E, S_max, D)`` features, ``(E, S_max)`` int64
        labels and ``(E, S_max)`` f32 mask (0 = padding row), built once per
        installed bank."""
        if self._ensemble_cache is None:
            feats = self.full_feat_sep
            dev, D = self.full_feat.device, self.full_feat.shape[1]
            s_max = max(len(f) for f in feats)
            ens_feat = torch.zeros((len(feats), s_max, D), dtype=self.full_feat.dtype, device=dev)
            ens_y = torch.zeros((len(feats), s_max), dtype=torch.int64, device=dev)
            ens_mask = torch.zeros((len(feats), s_max), dtype=torch.float32, device=dev)
            for e, (f, y) in enumerate(zip(feats, self.full_y_sep)):
                ens_feat[e, :len(f)] = f
                ens_y[e, :len(y)] = torch.as_tensor(y, device=dev)
                ens_mask[e, :len(f)] = 1.0
            self._ensemble_cache = (ens_feat, ens_y, ens_mask)
        return self._ensemble_cache

    def get_support(self, mode: str, x: Optional[torch.Tensor] = None):
        """Support features and labels for an inference mode; ``ensemble``
        gives the stacked banks with their mask, ``knn`` and ``hnsw`` the
        union of the neighbours of the query features ``x``."""
        if mode not in ("random", "full", "cluster", "ensemble", "knn", "hnsw"):
            raise NotImplementedError(
                f"mode {mode!r} has no support set here (ivf is NWNet.predict(mode='ivf'))")
        if not hasattr(self, "full_feat"):
            raise AttributeError("Did you run precompute()?")
        if mode == "random":
            idx, _ = self.random_sampler.sample()
            idx_t = torch.as_tensor(idx, device=self.full_feat.device)
            return self.full_feat[idx_t], self.full_y[idx_t]
        if mode == "cluster":
            return self.cluster_feat, self.cluster_y
        if mode == "ensemble":
            return self._ensemble_banks()
        if mode == "knn":
            return self.knn(x)
        if mode == "hnsw":
            return self.hnsw(x)
        return self.full_feat, self.full_y
