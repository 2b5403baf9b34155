"""IVF-pruned fused NW serving: the exact head over the bank tiles a batch
routes to.

Port of ``nwhead_tpu/ops/ivf.py``. A bank too large to stream whole for
every batch is built once as an IVF bank (``prepare_support_ivf``): its
rows are ordered so that each fixed ``block_s``-row tile is spatially
coherent (by class, or by k-means cluster ordered by dominant class), the
ordered bank is prepared with ``prepare_support(block_s=...)``, and the
per-tile centroids of the normalized features are the routing index. A
query batch is routed with one ``(B, n_tiles)`` product against the
centroids, each query's top ``n_probe`` tiles are merged into a
fixed-size union (``select_tiles``), and the prepared head streams only
those tiles (``nw_fused_from_prepared(tile_sel=...)``: K6 on the card).

Semantics are the JAX package's: the NW softmax runs over the union of
the batch's selected tiles; ``n_probe >= n_tiles`` reproduces full mode;
``group_b`` route-sorts the batch and gives each block of ``group_b``
queries its own union. Everything here is plain torch (the routing and
k-means products are XLA in the JAX package, not Pallas); the head is
the kernel. Nothing on the serving path reads a tile list or a union size
back to the host: every shape is static.

The k-means draws its randomness in two small functions,
``_fit_sample`` (the fit subsample) and ``_kmeans_pp_init`` (the
k-means++ seeding), from a ``torch.Generator`` seeded by ``seed``; the
JAX package draws them from ``jax.random``, so the two packages build the
same bank from the same draws only. ``concat_ivf`` waits for the bank
edits (``concat_prepared``, ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops.fused_nw import (
    PreparedSupport,
    _resolve_mode,
    _round_up,
    nw_fused_from_prepared,
    prepare_support,
)


class IVFPrepared(NamedTuple):
    """A prepared bank (tiled, ``prep.block_s`` rows a tile) and its
    tile-routing index."""

    prep: PreparedSupport
    cents: torch.Tensor   # (n_tiles, D) f32 tile centroids, normalized space
    c2: torch.Tensor      # (n_tiles,) f32 centroid self-norms (l2 routing)
    cvalid: torch.Tensor  # (n_tiles,) f32 1/0: the tile holds a valid row


def _fit_sample(n_valid: int, n_fit: int, generator: torch.Generator) -> np.ndarray:
    """``n_fit`` distinct positions in ``range(n_valid)``: the rows the
    k-means is fitted on (``jax.random.choice(..., replace=False)`` in the
    JAX package)."""
    return torch.randperm(n_valid, generator=generator)[:n_fit].numpy()


def _kmeans_pp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: the first center uniform, each next one drawn with
    probability proportional to its squared distance from the chosen set
    (``ivf.py:74-99``). The uniforms come from ``generator`` (on the host)
    and are turned into rows on ``x``'s device, so no step waits on it."""
    n = x.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64).to(x.device)
    x2 = torch.sum(x * x, dim=1)
    picks = [torch.clamp((u[:1] * n).long(), max=n - 1)]
    c = x.index_select(0, picks[0])[0]
    d2 = torch.clamp(x2 - 2.0 * (x @ c) + torch.sum(c * c), min=0.0)
    for i in range(1, k):
        cdf = torch.cumsum(d2.to(torch.float64), 0)
        picks.append(torch.clamp(torch.searchsorted(cdf, u[i:i + 1] * cdf[-1], right=True),
                                 max=n - 1))
        c = x.index_select(0, picks[-1])[0]
        d2 = torch.minimum(d2, torch.clamp(x2 - 2.0 * (x @ c) + torch.sum(c * c), min=0.0))
    return x.index_select(0, torch.cat(picks))


def _kmeans_fit(x: torch.Tensor, k: int, n_iter: int, generator: torch.Generator) -> torch.Tensor:
    """Matmul-form Lloyd on a fully valid sample ``x (n, d)`` f32 -> ``(k, d)``
    centroids (``ivf.py:102-117``). The largest temporary is the ``(n, k)``
    affinity; a center that loses every row stays where it was."""
    cents = _kmeans_pp_init(x, k, generator)
    for _ in range(n_iter):
        assign = _assign_chunk(x, cents)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
            0, assign, torch.ones_like(assign, dtype=x.dtype))
        sums = torch.zeros_like(cents).index_add_(0, assign, x)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def _assign_chunk(xc: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Each row's nearest center, by ``argmax(2 x.c - |c|^2)``."""
    aff = 2.0 * (xc @ cents.T) - torch.sum(cents * cents, dim=1)[None, :]
    return torch.argmax(aff, dim=1)


def _tile_centroids(sn: torch.Tensor, mask: torch.Tensor, n_tiles: int, block_s: int):
    """Mean of each tile's valid rows in normalized feature space:
    ``(cents (n_tiles, D), c2 (n_tiles,), cvalid (n_tiles,))``."""
    S, D = sn.shape
    x = torch.nn.functional.pad(sn.to(torch.float32), (0, 0, 0, n_tiles * block_s - S))
    m = torch.nn.functional.pad(mask.to(torch.float32), (0, n_tiles * block_s - S))
    # where, not multiply: a masked row may hold NaN after normalization.
    x = torch.where(m[:, None] > 0, x, 0.0)
    counts = m.reshape(n_tiles, block_s).sum(dim=1)
    cents = x.reshape(n_tiles, block_s, D).sum(dim=1) / torch.clamp(counts, min=1.0)[:, None]
    return cents, torch.sum(cents * cents, dim=1), (counts > 0).to(torch.float32)


def prepare_support_ivf(
    sfeat: torch.Tensor,
    sy,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    precision: str = "f32",
    support_mask: Optional[torch.Tensor] = None,
    block_s: Optional[int] = None,
    n_clusters: Optional[int] = None,
    cluster_iters: int = 10,
    sample: int = 65536,
    seed: int = 0,
    assign_chunk: int = 65536,
    order: str = "auto",
) -> IVFPrepared:
    """Build an IVF-routable prepared bank on ``sfeat``'s device.

    ``order="class"`` sorts rows by label (masked rows last): when classes
    are at least as many as tiles, each tile sits in one class's
    neighbourhood and no clustering is needed. ``"cluster"`` fits k-means
    (k-means++ seeded, Lloyd on a ``sample``-row subsample of the valid
    rows, assignment of the whole bank in chunks) and sorts rows by
    (cluster's dominant class, cluster id), masked rows last. ``"auto"``
    is ``"class"`` when ``n_classes >= n_tiles``, else ``"cluster"``.
    ``n_clusters`` defaults to the tile count; ``block_s`` to 1,024 rows.
    """
    if order not in ("auto", "class", "cluster"):
        raise ValueError(f"unknown order {order!r}")
    device = sfeat.device
    mask = (torch.ones(sfeat.shape[0], dtype=torch.float32, device=device)
            if support_mask is None else torch.as_tensor(support_mask).to(device))
    mode, _, _, sn = _resolve_mode(kernel, {"logit_scale": 0.0}, sfeat[:1], sfeat)
    S, D = sn.shape
    block_s = min(_round_up(block_s or 1024, 128), _round_up(S, 128))
    n_tiles = _round_up(S, block_s) // block_s
    k = min(n_clusters or max(2, min(n_tiles, 65536)), S)

    mask_np = mask.cpu().numpy() > 0
    valid_idx = np.nonzero(mask_np)[0]
    if valid_idx.size == 0:
        raise ValueError("prepare_support_ivf needs at least one valid row")
    sy_np = np.asarray(torch.as_tensor(sy).cpu()).astype(np.int64)
    if order == "auto":
        order = "class" if n_classes >= n_tiles else "cluster"

    if order == "class":
        perm = np.argsort(np.where(mask_np, sy_np, n_classes), kind="stable")
    else:
        generator = torch.Generator().manual_seed(seed)
        n_fit = min(sample, valid_idx.size)
        pick = _fit_sample(valid_idx.size, n_fit, generator)
        fit_x = sn[torch.as_tensor(valid_idx[pick], device=device)].to(torch.float32)
        k = min(k, n_fit)
        cents_fit = _kmeans_fit(fit_x, k, cluster_iters, generator)
        assign = np.concatenate([
            _assign_chunk(sn[lo:lo + assign_chunk].to(torch.float32), cents_fit).cpu().numpy()
            for lo in range(0, S, assign_chunk)]).astype(np.int64)
        # Masked rows last (cluster id k sorts past every real cluster).
        assign = np.where(mask_np, assign, k)
        # Clusters ordered by dominant class, then id; the dominant class by
        # np.unique over (cluster, class) codes and stable writes in
        # ascending count order (the last write per cluster is its argmax).
        pairs, cnt = np.unique(assign[mask_np] * np.int64(n_classes) + sy_np[mask_np],
                               return_counts=True)
        bycnt = np.argsort(cnt, kind="stable")
        dom = np.zeros(k + 1, np.int64)
        dom[pairs[bycnt] // n_classes] = pairs[bycnt] % n_classes
        dom[k] = n_classes
        perm = np.argsort(dom[assign] * np.int64(k + 1) + assign, kind="stable")

    if np.array_equal(perm, np.arange(S)):
        sfeat_s, sy_s, mask_s = sfeat, sy_np, mask
    else:
        perm_t = torch.as_tensor(perm, device=device)
        sfeat_s, sy_s, mask_s = sfeat[perm_t], sy_np[perm], mask[perm_t]
    prep = prepare_support(sfeat_s, sy_s, n_classes, kernel=kernel, precision=precision,
                           support_mask=mask_s, block_s=block_s, keep_order=True)
    _, _, _, sn_s = _resolve_mode(kernel, {"logit_scale": 0.0}, sfeat_s[:1], sfeat_s)
    cents, c2, cvalid = _tile_centroids(sn_s, mask_s, n_tiles, block_s)
    return IVFPrepared(prep=prep, cents=cents, c2=c2, cvalid=cvalid)


def _dedup_rows(ids: torch.Tensor, n_tiles: int, n_sel: int) -> torch.Tensor:
    """Row-wise sort and dedup of tile ids ``(G, k)`` to ``(G, n_sel)``
    int32: each row's distinct ids ascending, ``-1``-padded."""
    srt = torch.sort(ids, dim=1).values
    dup = torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool), srt[:, 1:] == srt[:, :-1]],
                    dim=1)
    uniq = torch.sort(torch.where(dup, n_tiles, srt), dim=1).values[:, :n_sel]
    return torch.where(uniq >= n_tiles, -1, uniq).to(torch.int32)


def _top_ids(affinity: torch.Tensor, n_probe: int) -> torch.Tensor:
    """Each row's ``n_probe`` largest entries' ids, the lower id first among
    equal values (``jax.lax.top_k``'s order; tiles that cannot be routed to
    tie at -inf)."""
    return torch.sort(affinity, dim=1, descending=True, stable=True).indices[:, :n_probe]


def select_tiles(affinity: torch.Tensor, n_probe: int) -> torch.Tensor:
    """Per-query top-``n_probe`` tiles of ``affinity (B, n_tiles)`` merged
    into one union: ``(n_sel,)`` int32, distinct ids ascending,
    ``-1``-padded, ``n_sel = min(B * n_probe, n_tiles)`` (the union can
    never be larger, so no id is dropped)."""
    B, n_tiles = affinity.shape
    n_probe = min(n_probe, n_tiles)
    ids = _top_ids(affinity, n_probe)
    return _dedup_rows(ids.reshape(1, -1), n_tiles, min(B * n_probe, n_tiles))[0]


def _route_affinity(qn: torch.Tensor, ivf: IVFPrepared, mode: str) -> torch.Tensor:
    """``(B, n_tiles)`` routing affinity of normalized queries: ``2 q.c -
    |c|^2`` in l2 mode (monotone in ``-|q - c|^2``), ``q.c`` in dot mode;
    ``-inf`` for tiles without a valid row."""
    aff = qn.to(torch.float32) @ ivf.cents.T
    if mode == "l2":
        aff = 2.0 * aff - ivf.c2[None, :]
    return torch.where(ivf.cvalid[None, :] > 0, aff, -torch.inf)


def route_tiles(qn: torch.Tensor, ivf: IVFPrepared, n_probe: int, *, mode: str) -> torch.Tensor:
    """The tile union of a normalized query batch (``select_tiles`` of
    its routing affinity)."""
    return select_tiles(_route_affinity(qn, ivf, mode), n_probe)


def _ivf_route(qfeat: torch.Tensor, ivf: IVFPrepared, *, kernel: str,
               kernel_params: Optional[Dict[str, Any]], n_probe: int,
               group_b: Optional[int]):
    """``(q, tile_sel, inv)``: the queries as the head takes them, their
    tile lists and the permutation back to input order (``None`` for one
    union). Grouped: the batch is padded to whole groups with copies of
    its last query (a real query's routing, so the last group's union
    gains nothing), route-sorted by each query's best tile, and given one
    union per ``group_b`` queries; ``out[inv][:B]`` restores the order."""
    mode, _, qn, _ = _resolve_mode(kernel, kernel_params or {}, qfeat)
    B = qfeat.shape[0]
    if group_b is None or B <= group_b:
        return qfeat, select_tiles(_route_affinity(qn, ivf, mode), n_probe), None
    n_tiles = ivf.cents.shape[0]
    np_eff = min(n_probe, n_tiles)
    b_pad = _round_up(B, group_b)
    if b_pad > B:
        qfeat = torch.cat([qfeat, qfeat[-1:].expand(b_pad - B, -1)])
        qn = torch.cat([qn, qn[-1:].expand(b_pad - B, -1)])
    ids = _top_ids(_route_affinity(qn, ivf, mode), np_eff)
    order = torch.argsort(ids[:, 0], stable=True)
    inv = torch.argsort(order, stable=True)
    tsel = _dedup_rows(ids[order].reshape(b_pad // group_b, group_b * np_eff), n_tiles,
                       min(group_b * np_eff, n_tiles))
    return qfeat[order], tsel, inv


def nw_fused_ivf_log_probs(
    qfeat: torch.Tensor,
    ivf: IVFPrepared,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    n_probe: int = 32,
    group_b: Optional[int] = None,
    partials: bool = False,
):
    """IVF-pruned NW log-probs ``(B, C)``: route, then stream only the
    selected tiles through the prepared head (K6 on the card).

    ``n_probe`` is the recall knob: tiles per query before the union.
    ``group_b=None``: one union for the whole batch (skewed traffic);
    ``group_b=g``: the batch is route-sorted and each block of ``g`` queries
    gets its own union, outputs restored to input order. ``n_probe >=
    n_tiles`` reproduces full mode in both shapes.

    ``partials=True`` returns the head's ``(m, l, acc)`` unfinalized (K6
    ``partials=True``), for one shard of a sharded bank; it takes one union
    for the batch, so it refuses ``group_b`` (the JAX package's sharded
    path never passes one)."""
    if partials and group_b is not None:
        raise ValueError("partials=True routes the batch to one union: pass no group_b")
    B = qfeat.shape[0]
    q, tsel, inv = _ivf_route(qfeat, ivf, kernel=kernel, kernel_params=kernel_params,
                              n_probe=n_probe, group_b=group_b)
    out = nw_fused_from_prepared(q, ivf.prep, n_classes, kernel=kernel,
                                 kernel_params=kernel_params, tile_sel=tsel, partials=partials)
    return out if inv is None else out[inv][:B]


class IVFAutoConfig(NamedTuple):
    """A calibrated IVF operating point (``ivf_auto_config``)."""

    n_probe: int
    group_b: Optional[int]
    agreement: float        # measured top-1 agreement on the calibration batch
    route_diversity: int    # distinct best tiles in the calibration batch


def ivf_auto_config(
    qfeat: torch.Tensor,
    ivf: IVFPrepared,
    n_classes: int,
    *,
    kernel: str = "euclidean",
    kernel_params: Optional[Dict[str, Any]] = None,
    target_agree: float = 0.999,
    probes: Tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
    group_b: int = 64,
    diverse_frac: float = 0.25,
) -> IVFAutoConfig:
    """Calibrate ``(n_probe, group_b)`` on a representative query batch:
    one exact pass over the whole bank, then routed passes at increasing
    ``n_probe`` until top-1 agreement with it reaches ``target_agree``.
    Grouping (``group_b``) engages when the whole-batch union could exceed
    ``diverse_frac`` of the tiles. When no probe below the tile count meets
    the target, the answer is ``n_probe = n_tiles``: full-mode routing."""
    exact = nw_fused_from_prepared(qfeat, ivf.prep, n_classes, kernel=kernel,
                                   kernel_params=kernel_params)
    ref_top1 = exact.argmax(1)
    mode, _, qn, _ = _resolve_mode(kernel, kernel_params or {}, qfeat)
    best = torch.argmax(_route_affinity(qn, ivf, mode), dim=1)
    diversity = int(torch.unique(best).numel())
    n_tiles = int(ivf.cents.shape[0])
    B = int(qfeat.shape[0])

    chosen = None
    for p in probes:
        if p >= n_tiles:
            break
        g = group_b if B > group_b and min(B * p, n_tiles) > diverse_frac * n_tiles else None
        out = nw_fused_ivf_log_probs(qfeat, ivf, n_classes, kernel=kernel,
                                     kernel_params=kernel_params, n_probe=p, group_b=g)
        agree = float((out.argmax(1) == ref_top1).float().mean())
        chosen = IVFAutoConfig(p, g, agree, diversity)
        if agree >= target_agree:
            return chosen
    return IVFAutoConfig(n_tiles, chosen.group_b if chosen is not None else None, 1.0,
                         diversity)
