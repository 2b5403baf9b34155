"""Support-sharded NW serving: the bank's rows split over the mesh's
``support`` axis, each shard's online-softmax partials merged exactly.

Port of ``nwhead_tpu/parallel/sharded_bank.py`` (``nw_partials``,
``merge_partials``, ``sharded_ensemble_predict_fn``,
``sharded_knn_predict_fn``, ``ShardedSupportBank``). Each shard computes, over its
own rows, the running max ``m``, the normalizer ``l`` and the label sums
``acc`` (both relative to ``m``), and the shards combine as

    m* = max_k m_k,  w_k = exp(m_k - m*)  (0 for a shard with no valid row)
    l* = sum_k l_k w_k,  acc* = sum_k acc_k w_k,  out = log(acc* / l* + 1e-12),

which is exact: the payload is ``(B, C + 2)`` per shard whatever its size.
The JAX package computes the max and sums with ``pmax``/``psum`` inside a
``shard_map``; here one process drives the mesh (``parallel/mesh.py``): each
data row of the mesh takes its slice of the batch, runs every support
shard on that shard's device, and merges the partials on the row's first
device, the sums in shard order.

On the card a raw shard runs K1 ``partials=True`` (``nw_fused_partials``),
a prepared one K2/K4/K5 ``partials=True`` and, routed, K6 ``partials=True``
(``ops/fused_nw.py``); on the CPU they run their plain versions. The
ensemble mode shards each environment's bank the same way and merges each
environment's partials before the mean in probability space (K1
``partials=True`` once per shard and environment). The knn mode takes each
shard's local k nearest, the global k nearest among every shard's
candidates for the whole batch, then the head over the union with each
row's multiplicity folded into its score (plain torch, as in the JAX
package). JAX's ``all_gather`` over the mesh is a concatenation in shard
order here. The TPU's widening of the class window across shards
(``concat_prepared``) is a Mosaic layout matter and has no counterpart.
``remove_rows`` and the row map wait for the bank edits (ROADMAP.md queue
1, item 9), the mesh's AOT export for item 13.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops.fused_nw import (
    _NEG_INF,
    PreparedSupport,
    _resolve_mode,
    _softmax_partials_plain,
    nw_fused_from_prepared,
    nw_fused_partials,
    prepare_support,
)
from nwhead_tpu_torch.ops.ivf import IVFPrepared, _tile_centroids, nw_fused_ivf_log_probs
from nwhead_tpu_torch.ops.kernels import get_kernel, pairwise_sqdist
from nwhead_tpu_torch.ops.knn import f32_products
from nwhead_tpu_torch.ops.nw import LOG_FLOOR
from nwhead_tpu_torch.parallel.mesh import Mesh

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nw_partials(
    qfeat: torch.Tensor,
    sfeat: torch.Tensor,
    sy: torch.Tensor,
    mask: torch.Tensor,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    use_fused: Optional[bool] = None,
) -> Partials:
    """One support shard's online-softmax partials ``(m (B, 1), l (B, 1),
    acc (B, C))``: ``qfeat (B, D)``, ``sfeat (S, D)``, ``sy (S,)``, ``mask
    (S,)`` (0 = masked). ``use_fused`` (default: on a CUDA tensor) runs K1
    ``partials=True``; otherwise the similarity matrix is materialized, as
    the JAX package does off the TPU. Both are exact."""
    if use_fused is None:
        use_fused = qfeat.device.type == "cuda"
    if use_fused:
        return nw_fused_partials(qfeat, sfeat, sy, n_classes, kernel=kernel,
                                 kernel_params=kernel_params, support_mask=mask)
    kernel_fn, init_params = get_kernel(kernel)
    valid = torch.as_tensor(mask, device=sfeat.device) > 0
    scores = kernel_fn(kernel_params if kernel_params is not None else init_params,
                       qfeat, sfeat)
    scores = torch.where(valid[None, :], scores, _NEG_INF)
    labels = torch.where(valid, torch.as_tensor(sy, device=sfeat.device), -1)
    return _softmax_partials_plain(scores, labels, n_classes)


def merge_partials(parts: Sequence[Partials]) -> torch.Tensor:
    """The exact merge of the shards' ``(m, l, acc)`` (in support order, on
    one device) into log-probs ``(B, C)``: ``nwhead_tpu/parallel/
    sharded_bank.py:merge_partials`` with its collectives written out, the
    sums taken in shard order."""
    m_g = parts[0][0]
    for m, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = acc_g = None
    for m, l, acc in parts:
        w = torch.where(m > _NEG_INF / 2, torch.exp(m - m_g), 0.0)
        l_g = l * w if l_g is None else l_g + l * w
        acc_g = acc * w if acc_g is None else acc_g + acc * w
    return torch.log(acc_g / torch.clamp(l_g, min=1e-30) + LOG_FLOOR)


# One support shard's raw rows on one device: (features, labels, mask).
RawShard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _place(mesh: Mesh, arrays: Sequence[torch.Tensor],
           axis: int) -> List[Dict[torch.device, RawShard]]:
    """``arrays`` split into ``n_support`` equal pieces along ``axis`` (its
    length a multiple of the shard count), piece ``k`` on every distinct
    device of support column ``k``."""
    devices = mesh.devices[:, :, 0]
    n_shards = mesh.shape["support"]
    size = arrays[0].shape[axis]
    if size % n_shards:
        raise ValueError(f"{size} support rows do not split over {n_shards} shards: pad them "
                         "to a multiple with masked rows")
    loc = size // n_shards
    return [{dev: tuple(a.narrow(axis, k * loc, loc).to(dev) for a in arrays)
             for dev in dict.fromkeys(devices[:, k])} for k in range(n_shards)]


def _data_rows(mesh: Mesh, qfeat: torch.Tensor) -> List[torch.Tensor]:
    """The batch split over the mesh's data rows."""
    n_data = mesh.shape["data"]
    B = qfeat.shape[0]
    if B % n_data:
        raise ValueError(f"a batch of {B} queries does not split over the mesh's "
                         f"{n_data} data rows")
    rows = B // n_data
    return [qfeat[d * rows:(d + 1) * rows] for d in range(n_data)]


def sharded_ensemble_predict_fn(
    mesh: Mesh,
    ens_feat: torch.Tensor,
    ens_y: torch.Tensor,
    ens_mask: torch.Tensor,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    use_fused: Optional[bool] = None,
):
    """Support-sharded ensemble predict: the mean in probability space of
    the environments' heads (``nw.py:143-154``) over banks split over the
    mesh's ``support`` axis. ``ens_feat (E, S_pad, D)``, ``ens_y (E,
    S_pad)`` and ``ens_mask (E, S_pad)`` (0 = padding) are the stacked
    environment banks, ``S_pad`` a multiple of the shard count; shard ``k``
    takes rows ``[k * S_pad / n, (k + 1) * S_pad / n)`` of every
    environment onto the devices of its column. Each data row's queries run
    ``nw_partials`` (K1 ``partials=True`` on the card) on every shard for
    each environment in order, merge each environment's partials exactly,
    and add its probabilities. Returns ``qfeat (B, D) -> (B, C)`` log-probs."""
    shards = _place(mesh, (ens_feat, ens_y, ens_mask), axis=1)
    n_envs = ens_feat.shape[0]
    devices = mesh.devices[:, :, 0]

    @torch.inference_mode()
    def predict(qfeat: torch.Tensor) -> torch.Tensor:
        outs = []
        for d, q in enumerate(_data_rows(mesh, qfeat)):
            home = devices[d, 0]
            total = None
            for e in range(n_envs):
                parts = []
                for k, copies in enumerate(shards):
                    dev = devices[d, k]
                    f, y, m = copies[dev]
                    part = nw_partials(q.to(dev), f[e], y[e], m[e], n_classes, kernel=kernel,
                                       kernel_params=kernel_params, use_fused=use_fused)
                    parts.append(tuple(t.to(home) for t in part))
                # Each environment's log-probs carry the 1e-12 floor, as in
                # the single-device ensemble; the mean is in probability space.
                p = torch.exp(merge_partials(parts))
                total = p if total is None else total + p
            outs.append(torch.log(total / n_envs).to(qfeat.device))
        return torch.cat(outs)

    return predict


def _knn_predict_fn(mesh: Mesh, shards: List[Dict[torch.device, RawShard]], n_classes: int,
                    n_neighbors: int, kernel: str,
                    kernel_params: Optional[Dict[str, Any]]):
    """``sharded_knn_predict_fn`` over shards already placed on the mesh."""
    kernel_fn, init_params = get_kernel(kernel)
    kparams = kernel_params if kernel_params is not None else init_params
    devices = mesh.devices[:, :, 0]
    k = n_neighbors
    loc = next(iter(shards[0].values()))[0].shape[0]
    if not 1 <= k <= loc:
        raise ValueError(f"n_neighbors={k} must be at least 1 and at most the {loc} rows "
                         "of a shard")

    @torch.inference_mode()
    def predict(qfeat: torch.Tensor) -> torch.Tensor:
        qs = _data_rows(mesh, qfeat)
        first = devices[0, 0]
        # Stage 1: each shard's k nearest (L2 whatever the head's kernel, as
        # the reference's index), ties by the lowest row; then the k nearest
        # of each query among every shard's candidates, the batch's data
        # rows gathered in order (the union is over the whole batch).
        cand_s, cand_i = [], []
        for d, q in enumerate(qs):
            for j, copies in enumerate(shards):
                dev = devices[d, j]
                f, _, m = copies[dev]
                with f32_products():
                    d2 = pairwise_sqdist(q.to(dev, torch.float32), f.to(torch.float32))
                neg = torch.where(m[None, :] > 0, -d2, float("-inf"))
                s_, i_ = torch.sort(neg, dim=1, descending=True, stable=True)
                cand_s.append(s_[:, :k].to(first))
                cand_i.append((i_[:, :k] + j * loc).to(first))
        n_s = len(shards)
        per_q_s = torch.cat([torch.cat(cand_s[d * n_s:(d + 1) * n_s], 1) for d in range(len(qs))])
        per_q_i = torch.cat([torch.cat(cand_i[d * n_s:(d + 1) * n_s], 1) for d in range(len(qs))])
        top_s, pos = torch.sort(per_q_s, dim=1, descending=True, stable=True)
        union = torch.gather(per_q_i, 1, pos[:, :k]).reshape(-1)
        # A shard with fewer than k valid rows fills its candidates with
        # masked ones at -inf; where the whole bank is short of k they would
        # survive the second selection, so they are dropped by score.
        union_ok = (top_s[:, :k] > float("-inf")).reshape(-1)

        # Stage 2: the head over the union rows, each row's multiplicity c
        # folded in as + ln c (c exp(s) = exp(s + ln c)), per shard, then
        # the exact merge.
        outs = []
        for d, q in enumerate(qs):
            home = devices[d, 0]
            parts = []
            for j, copies in enumerate(shards):
                dev = devices[d, j]
                f, y, _ = copies[dev]
                rows = union.to(dev) - j * loc
                valid = (rows >= 0) & (rows < loc) & union_ok.to(dev)
                counts = torch.zeros(loc, dtype=torch.float32, device=dev).index_add_(
                    0, rows.clamp(0, loc - 1), valid.to(torch.float32))
                with f32_products():
                    scores = kernel_fn(kparams, q.to(dev), f)
                adj = torch.where(counts[None, :] > 0,
                                  scores + torch.log(counts.clamp(min=1.0))[None, :], _NEG_INF)
                part = _softmax_partials_plain(adj, y, n_classes)
                parts.append(tuple(t.to(home) for t in part))
            outs.append(merge_partials(parts).to(qfeat.device))
        return torch.cat(outs)

    return predict


def sharded_knn_predict_fn(
    mesh: Mesh,
    feat: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    n_classes: int,
    n_neighbors: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
):
    """Support-sharded exact k-NN predict: the reference's knn mode
    (``nwhead/utils.py:178-193`` and the head's shared 2-D support,
    ``nw.py:277-289``), its union with duplicates kept. ``feat (S_pad, D)``,
    ``labels (S_pad,)`` and ``mask (S_pad,)`` split over the ``support``
    axis as ``ShardedSupportBank`` splits them (``S_pad`` a multiple of the
    shard count, ``n_neighbors`` at most a shard's rows). No feature row
    leaves its shard: only the candidates' scores and ids, and the union's
    ids, move. Returns ``qfeat (B, D) -> (B, C)`` log-probs."""
    shards = _place(mesh, (feat, labels, mask), axis=0)
    return _knn_predict_fn(mesh, shards, n_classes, n_neighbors, kernel, kernel_params)


# The JAX package's default tile size of a prepared bank (``pallas_nw.py``
# ``_serving_block_s``): a sharded IVF bank routes over these tiles, so the
# port tiles each shard as JAX does, to route to the same tiles.
_BLOCK_S_GIANT, _BLOCK_S_GIANT_ROWS = 2048, 262_144
_BLOCK_S_HUGE, _BLOCK_S_HUGE_ROWS = 4096, 4_194_304


def _serving_block_s(S: int) -> int:
    """Rows per tile of a prepared bank of ``S`` rows: 1,024, 2,048 from
    262,144 rows, 4,096 from 4,194,304 (``prepare_support`` then caps it at
    ``round_up(S, 128)``)."""
    if S >= _BLOCK_S_HUGE_ROWS:
        return _BLOCK_S_HUGE
    return _BLOCK_S_GIANT if S >= _BLOCK_S_GIANT_ROWS else 1024


class Shard(NamedTuple):
    """One support shard on one device: the raw rows (``feat``, ``labels``,
    ``mask``), or a prepared bank, with its tile-routing index when the
    bank was built with ``ivf=True``."""

    feat: Optional[torch.Tensor] = None    # (local, D) f32
    labels: Optional[torch.Tensor] = None  # (local,) int32
    mask: Optional[torch.Tensor] = None    # (local,) f32, 0 = masked (padding)
    prepared: Optional[PreparedSupport] = None
    ivf: Optional[IVFPrepared] = None

    def to(self, device: torch.device) -> "Shard":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):  # PreparedSupport, IVFPrepared
                return type(x)(*(move(v) for v in x))
            return x.to(device) if isinstance(x, torch.Tensor) else x

        return Shard(*(move(v) for v in self))


def _ivf_shard(f: torch.Tensor, lab: np.ndarray, m: np.ndarray, n_classes: int, kernel: str,
               precision: str) -> IVFPrepared:
    """A shard class-sorted (stably, masked rows last) and prepared in that
    order at the JAX package's tile size, with its tiles' centroids
    (``sharded_bank.py:365-395``)."""
    perm = np.argsort(np.where(m > 0, lab, n_classes), kind="stable")
    perm_t = torch.as_tensor(perm, device=f.device)
    f, lab, m = f[perm_t], lab[perm], m[perm]
    mask = torch.as_tensor(m, device=f.device)
    prep = prepare_support(f, lab, n_classes, kernel=kernel, support_mask=mask,
                           precision=precision, block_s=_serving_block_s(len(lab)),
                           keep_order=True)
    _, _, _, sn = _resolve_mode(kernel, {"logit_scale": 0.0}, f[:1], f)
    cents, c2, cvalid = _tile_centroids(sn, mask, prep.labels.shape[0] // prep.block_s,
                                        prep.block_s)
    return IVFPrepared(prep=prep, cents=cents, c2=c2, cvalid=cvalid)


@dataclass
class ShardedSupportBank:
    """A support bank whose rows are split over the mesh's ``support``
    axis: ``shards[k]`` maps each distinct device of support column ``k``
    to its copy of shard ``k``.

    Raw mode keeps each shard's rows (K1 ``partials=True`` per shard on the
    card); prepared mode one ``prepare_support`` bank a shard at f32, bf16,
    int8 or int4 (K2/K4/K5 ``partials=True``), and with ``ivf=True`` a
    tile-routing index a shard (K6 ``partials=True`` over the tiles each
    shard routes to)."""

    mesh: Mesh
    n_classes: int
    shards: List[Dict[torch.device, Shard]]
    kernel: str = "euclidean"
    precision: str = "f32"
    local: int = 0  # rows a shard, padding included

    @staticmethod
    def build(
        feats,
        labels,
        mesh: Mesh,
        n_classes: int,
        kernel: str = "euclidean",
        precision: str = "f32",
        use_prepared: Optional[bool] = None,
        ivf: bool = False,
    ) -> "ShardedSupportBank":
        """Split ``feats (S, D)`` and ``labels (S,)`` into ``n_support``
        shards of ``ceil(S / n_support)`` rows, the last ones padded with
        masked rows, and build each shard on the devices of its column.
        ``use_prepared`` defaults to prepared on a CUDA mesh and raw on the
        CPU, unless ``precision`` needs the prepared path. ``ivf=True``
        (prepared mode only) class-sorts each shard and adds its tiles'
        routing index, for ``predict_fn(ivf_n_probe=...)``."""
        devices = mesh.devices[:, :, 0]
        if use_prepared is None:
            use_prepared = devices[0, 0].type == "cuda" or precision != "f32"
        if precision != "f32" and not use_prepared:
            raise ValueError("bf16/int8 sharded banks require the prepared path "
                             "(use_prepared=True)")
        feats = torch.as_tensor(feats)
        labels_np = np.asarray(torch.as_tensor(labels).cpu()).astype(np.int64)
        n_shards = mesh.shape["support"]
        S, D = feats.shape
        local = -(-S // n_shards)
        shards = []
        for k in range(n_shards):
            lo, hi = min(S, k * local), min(S, (k + 1) * local)
            home = devices[0, k]
            f = torch.zeros((local, D), dtype=torch.float32, device=home)
            f[:hi - lo] = feats[lo:hi].to(home, torch.float32)
            lab = np.zeros(local, np.int64)
            lab[:hi - lo] = labels_np[lo:hi]
            m = np.zeros(local, np.float32)
            m[:hi - lo] = 1.0
            if ivf and use_prepared:
                shard = Shard(ivf=_ivf_shard(f, lab, m, n_classes, kernel, precision))
            elif use_prepared:
                shard = Shard(prepared=prepare_support(
                    f, lab, n_classes, kernel=kernel, precision=precision,
                    support_mask=torch.as_tensor(m, device=home)))
            else:
                shard = Shard(feat=f, labels=torch.as_tensor(lab.astype(np.int32), device=home),
                              mask=torch.as_tensor(m, device=home))
            shards.append({dev: shard if dev == home else shard.to(dev)
                           for dev in dict.fromkeys(devices[:, k])})
        return ShardedSupportBank(mesh=mesh, n_classes=n_classes, shards=shards, kernel=kernel,
                                  precision=precision, local=local)

    @property
    def prepared(self) -> bool:
        """Whether the shards are prepared banks (else raw rows)."""
        shard = next(iter(self.shards[0].values()))
        return shard.feat is None

    @property
    def ivf(self) -> bool:
        """Whether the shards carry a tile-routing index."""
        return next(iter(self.shards[0].values())).ivf is not None

    @property
    def capacity(self) -> int:
        """Array rows over all shards (live and padding, tiles' padding
        included)."""
        total = 0
        for copies in self.shards:
            shard = next(iter(copies.values()))
            bank = shard.ivf.prep if shard.ivf is not None else shard.prepared
            total += int(shard.mask.shape[0] if bank is None else bank.labels.shape[0])
        return total

    def _shard_partials(self, q: torch.Tensor, shard: Shard, kernel_params,
                        ivf_n_probe: Optional[int]) -> Partials:
        if shard.ivf is not None and ivf_n_probe is not None:
            return nw_fused_ivf_log_probs(q, shard.ivf, self.n_classes, kernel=self.kernel,
                                          kernel_params=kernel_params, n_probe=ivf_n_probe,
                                          partials=True)
        bank = shard.ivf.prep if shard.ivf is not None else shard.prepared
        if bank is not None:
            return nw_fused_from_prepared(q, bank, self.n_classes, kernel=self.kernel,
                                          kernel_params=kernel_params, partials=True)
        return nw_partials(q, shard.feat, shard.labels, shard.mask, self.n_classes,
                           kernel=self.kernel, kernel_params=kernel_params)

    def predict_fn(self, kernel_params: Optional[Dict[str, Any]] = None,
                   ivf_n_probe: Optional[int] = None):
        """``qfeat (B, D) -> (B, C)`` log-probs on ``qfeat``'s device. The
        batch splits over the ``data`` axis (``B`` a multiple of its size);
        each data row runs every support shard on that shard's device and
        merges the partials on its first device. ``ivf_n_probe`` routes each
        query batch against each shard's own tiles and streams only the
        selected ones (a bank built with ``ivf=True``)."""
        if ivf_n_probe is not None:
            if not self.prepared:
                raise ValueError("ivf_n_probe needs the prepared sharded path (raw-mode "
                                 "banks have no tile structure to route over)")
            if not self.ivf:
                raise ValueError("ivf_n_probe needs a routing index — build the sharded "
                                 "bank with ivf=True")
        devices = self.mesh.devices[:, :, 0]

        @torch.inference_mode()
        def predict(qfeat: torch.Tensor) -> torch.Tensor:
            outs = []
            for d, q in enumerate(_data_rows(self.mesh, qfeat)):
                home = devices[d, 0]
                parts = []
                for k, copies in enumerate(self.shards):
                    dev = devices[d, k]
                    part = self._shard_partials(q.to(dev), copies[dev], kernel_params,
                                                ivf_n_probe)
                    parts.append(tuple(t.to(home) for t in part))
                outs.append(merge_partials(parts).to(qfeat.device))
            return torch.cat(outs)

        return predict

    def knn_predict_fn(self, n_neighbors: int, kernel_params: Optional[Dict[str, Any]] = None):
        """``sharded_knn_predict_fn`` over this bank's raw shards (a prepared
        bank keeps no raw rows to search)."""
        if self.prepared:
            raise ValueError("the sharded knn predict searches raw rows: build the bank "
                             "with use_prepared=False")
        shards = [{dev: (s.feat, s.labels, s.mask) for dev, s in copies.items()}
                  for copies in self.shards]
        return _knn_predict_fn(self.mesh, shards, self.n_classes, n_neighbors, self.kernel,
                               kernel_params)
