"""Per-class k-means for cluster-mode inference.

Port of ``nwhead_tpu/ops/kmeans.py``. All classes are fitted at once: masked
Lloyd iterations over a ``(C, n_max, d)`` tensor of each class's rows,
zero-padded, on the device the features live on (``batched_kmeans``).
``compute_clusters`` builds the cluster bank: ``n_clusters`` centroids per
class, class blocks in ``np.unique`` order.

The Lloyd step is the JAX package's: each row's nearest centroid by
``argmin`` of the squared differences summed (the first on a tie), the
centroid sums as a one-hot product summed over the rows (elementwise in
f32: no TF32 matmul, and no ``index_add_``, whose float sums on CUDA are
not deterministic), an empty cluster keeping its centroid.

Seeding: kmeans++ (``kmeanspp_init``) with the uniforms drawn from a
``torch.Generator`` seeded by ``seed``. The JAX package draws them from
``jax.random``, so the two packages give the same centroids from the same
initial centroids (``init=``), not from the same seed.
``impl="sklearn"`` makes the reference's exact per-class host call,
``KMeans(n_clusters, random_state=seed).fit`` on float64, rounded to f32:
bit-identical with the JAX package's. It needs scikit-learn, imported
only there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Classes fitted together are chunked so that the (classes, n_max, k, d)
# temporaries of a Lloyd step stay under this many bytes.
_CHUNK_BYTES = 256 << 20


def _sqdist(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """``sum((x - c)^2)`` for every row and centroid: ``x (C, n, d)``,
    ``cents (C, k, d)`` -> ``(C, n, k)``."""
    return torch.sum((x[:, :, None, :] - cents[:, None, :, :]) ** 2, dim=-1)


def kmeanspp_init(x: torch.Tensor, mask: torch.Tensor, k: int,
                  generator: torch.Generator) -> torch.Tensor:
    """kmeans++ seeding for every class at once (``_kmeanspp_init``,
    ``kmeans.py:24``): the first centroid uniform over a class's valid rows,
    each next one drawn with probability proportional to ``dmin + 1e-20``,
    ``dmin`` the squared distance to the nearest chosen centroid (uniform
    when all are 0). ``x (C, n, d)``, ``mask (C, n)`` -> ``(C, k, d)``. The
    ``(C, k)`` uniforms come from ``generator`` on the host."""
    C, n, d = x.shape
    u = torch.rand((C, k), generator=generator, dtype=torch.float64).to(x.device)
    valid = mask > 0

    def draw(weights: torch.Tensor, i: int) -> torch.Tensor:
        cdf = torch.cumsum(weights, dim=1)
        pick = torch.searchsorted(cdf, (u[:, i] * cdf[:, -1])[:, None].contiguous(), right=True)
        pick = torch.clamp(pick, max=n - 1)
        return torch.gather(x, 1, pick[:, :, None].expand(C, 1, d))

    cents = [draw(valid.to(torch.float64), 0)]
    dmin = torch.full((C, n), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        dmin = torch.minimum(dmin, _sqdist(x, cents[-1])[:, :, 0])
        weights = torch.where(valid, dmin.to(torch.float64) + 1e-20, 0.0)
        cents.append(draw(weights, i))
    return torch.cat(cents, dim=1)


def _lloyd(x: torch.Tensor, mask: torch.Tensor, cents: torch.Tensor, n_iter: int):
    """Masked Lloyd iterations (``_lloyd_one_class``, ``kmeans.py:54``)."""
    k = cents.shape[1]
    for _ in range(n_iter):
        assign = torch.argmin(_sqdist(x, cents), dim=-1)  # (C, n)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) * mask[:, :, None]
        counts = torch.sum(onehot, dim=1)  # (C, k)
        sums = torch.sum(onehot[:, :, :, None] * x[:, :, None, :], dim=1)  # "nk,nd->kd"
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        cents = torch.where(counts[:, :, None] > 0, new, cents)
    return cents


def batched_kmeans(
    x: torch.Tensor,
    mask: torch.Tensor,
    n_clusters: int,
    n_iter: int = 25,
    *,
    init: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> torch.Tensor:
    """Masked Lloyd over classes (``batched_kmeans``, ``kmeans.py:73``):
    ``x (C, n_max, d)`` f32, ``mask (C, n_max)`` (1 = a row of the class) ->
    centroids ``(C, n_clusters, d)`` on ``x``'s device. ``init (C,
    n_clusters, d)`` gives the initial centroids; without it they are
    seeded by kmeans++ from ``seed``."""
    x = x.to(torch.float32)
    mask = torch.as_tensor(mask, device=x.device).to(torch.float32)
    if init is None:
        init = kmeanspp_init(x, mask, n_clusters, torch.Generator().manual_seed(seed))
    init = torch.as_tensor(init, device=x.device).to(torch.float32)
    if init.shape != (x.shape[0], n_clusters, x.shape[2]):
        raise ValueError(f"init {tuple(init.shape)} for {x.shape[0]} classes of "
                         f"{n_clusters} centroids of width {x.shape[2]}")
    C, n, d = x.shape
    step = max(1, _CHUNK_BYTES // max(1, n * n_clusters * d * 4))
    return torch.cat([_lloyd(x[i:i + step], mask[i:i + step], init[i:i + step], n_iter)
                      for i in range(0, C, step)])


def pad_by_class(embeddings: torch.Tensor, labels) -> Tuple[torch.Tensor, torch.Tensor,
                                                            np.ndarray]:
    """Each class's rows, in their order, zero-padded to the largest class:
    ``(x (C, n_max, d), mask (C, n_max), classes)`` on ``embeddings``'
    device, classes in ``np.unique`` order."""
    labels = np.asarray(labels)
    classes, inverse, counts = np.unique(labels, return_inverse=True, return_counts=True)
    order = np.argsort(inverse, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cls = inverse[order]
    pos = np.arange(len(order)) - starts[cls]
    C, n_max, d = len(classes), int(counts.max()), embeddings.shape[1]
    dev = embeddings.device
    cls_t, pos_t = torch.from_numpy(cls).to(dev), torch.from_numpy(pos).to(dev)
    x = torch.zeros((C, n_max, d), dtype=torch.float32, device=dev)
    x[cls_t, pos_t] = embeddings[torch.from_numpy(order).to(dev)].to(torch.float32)
    mask = torch.zeros((C, n_max), dtype=torch.float32, device=dev)
    mask[cls_t, pos_t] = 1.0
    return x, mask, classes


def compute_clusters(
    embeddings,
    labels,
    n_clusters: int,
    closest: bool = False,
    seed: int = 0,
    impl: str = "device",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class k-means support construction (``compute_clusters``,
    ``kmeans.py:88``): ``(sfeat (C * n_clusters, d) f32, slabel (C *
    n_clusters,) int64)``, class blocks in ``np.unique(labels)`` order, each
    label repeated ``n_clusters`` times, on ``embeddings``' device (the CPU
    for a numpy array). ``closest`` replaces each centroid by the nearest
    row of its class (on the host, as the JAX package does). ``impl``:
    ``"device"`` (``batched_kmeans`` with kmeans++ from ``seed``) or
    ``"sklearn"`` (the reference's host ``KMeans(n_clusters,
    random_state=seed)``, bit-identical with the JAX package's)."""
    emb = torch.as_tensor(embeddings)
    labels = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels)
    dev = emb.device
    if impl == "sklearn":
        sfeat_np, classes = _sklearn_clusters(emb.cpu().numpy(), labels, n_clusters, closest,
                                              seed)
        sfeat = torch.from_numpy(sfeat_np).to(dev)
    elif impl == "device":
        x, mask, classes = pad_by_class(emb, labels)
        cents = batched_kmeans(x, mask, n_clusters, seed=seed)  # (C, k, d)
        if closest:
            emb_np = emb.cpu().numpy()
            sfeat = torch.from_numpy(np.concatenate([
                _closest_rows(c, emb_np[labels == cls])
                for c, cls in zip(cents.cpu().numpy(), classes)])).to(dev)
        else:
            sfeat = cents.reshape(-1, x.shape[2])
    else:
        raise ValueError(f"Unknown kmeans impl: {impl!r}")
    slabel = torch.from_numpy(np.repeat(classes, n_clusters).astype(np.int64)).to(dev)
    return sfeat, slabel


def _sklearn_clusters(embeddings: np.ndarray, labels: np.ndarray, n_clusters: int,
                      closest: bool, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's host path, step for step (``kmeans.py:125-136``)."""
    from sklearn.cluster import KMeans

    embeddings = np.asarray(embeddings, dtype=np.float32)
    classes = np.unique(labels)
    sfeat = []
    for c in classes:
        g = embeddings[labels == c]
        # float64 fit (the reference's torch input is upcast so), centroids
        # rounded to f32.
        km = KMeans(n_clusters=n_clusters, random_state=seed).fit(g.astype(np.float64))
        cents = km.cluster_centers_.astype(np.float32)
        sfeat.append(_closest_rows(cents, g) if closest else cents)
    return np.concatenate(sfeat, axis=0), classes


def _closest_rows(cents: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Each centroid's nearest row of its class ``g``, on the host in the
    JAX package's numpy arithmetic: a centroid of two rows is equidistant
    from both, and the rounding of this sum decides which is taken."""
    d2 = ((cents[:, None, :] - g[None, :, :]) ** 2).sum(-1)
    return g[d2.argmin(-1)]
