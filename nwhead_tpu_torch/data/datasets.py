"""In-memory datasets for the port.

Port of ``ArrayDataset``, ``make_synthetic_dataset`` and
``make_digits_dataset`` from ``nwhead_tpu/data/datasets.py``. The dataset
protocol is the JAX package's: ``.targets``, ``.num_classes``,
``gather(indices) -> (n, H, W, C) float32`` and ``__len__``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# make_synthetic_dataset draws its noise in row chunks of about this many
# float64 bytes, so a CUB-sized set (3.6 GB of f32) needs no 7.2 GB float64
# temporary. Chunked draws from one Generator equal a single draw.
_DRAW_CHUNK_BYTES = 64 << 20


class ArrayDataset:
    """In-memory dataset over (N, H, W, C) arrays."""

    def __init__(
        self,
        images: np.ndarray,
        targets: Sequence[int],
        num_classes: Optional[int] = None,
    ) -> None:
        if len(images) != len(targets):
            raise ValueError(f"{len(images)} images for {len(targets)} targets")
        self.images = images
        self.targets = np.asarray(targets)
        self.num_classes = (
            num_classes if num_classes is not None else int(self.targets.max()) + 1
        )

    def __len__(self) -> int:
        return len(self.images)

    def gather(self, indices) -> np.ndarray:
        return self.images[np.asarray(indices)].astype(np.float32)


def make_digits_dataset(train: bool = True, size: int = 32) -> ArrayDataset:
    """scikit-learn's bundled handwritten digits (1797 8x8 images, 10
    classes): per class, every 5th item is validation; pixels scale to
    [0, 1], upsample to ``size`` (nearest) and repeat to 3 channels.
    Needs scikit-learn, imported only here."""
    from sklearn.datasets import load_digits

    if size % 8:
        raise ValueError(f"size must be a multiple of 8, got {size}")
    d = load_digits()
    imgs = (d.images / 16.0).astype(np.float32)
    y = d.target.astype(np.int64)
    idx_parts = []
    for c in range(10):
        ci = np.where(y == c)[0]
        val = np.arange(len(ci)) % 5 == 0
        idx_parts.append(ci[~val] if train else ci[val])
    idx = np.sort(np.concatenate(idx_parts))
    k = size // 8
    x = np.kron(imgs[idx], np.ones((1, k, k), np.float32))
    x = np.repeat(x[..., None], 3, axis=-1)
    return ArrayDataset(x, y[idx], num_classes=10)


def make_synthetic_dataset(
    n: int = 64,
    n_classes: int = 4,
    size: int = 8,
    channels: int = 3,
    seed: int = 0,
    class_patterns: float = 0.0,
    pattern_seed: int = 1234,
) -> ArrayDataset:
    """Class-separable synthetic images: mean intensity encodes the class,
    plus N(0, 0.1) noise, plus (``class_patterns > 0``) a fixed random
    pattern per class drawn from ``pattern_seed``. The same arguments give
    the same array as the JAX package's function."""
    rng = np.random.default_rng(seed)
    targets = np.tile(np.arange(n_classes), n // n_classes + 1)[:n]
    row_shape = (size, size, channels)
    code = (targets / n_classes)[:, None, None, None].astype(np.float32)
    pat = None
    if class_patterns > 0:
        prng = np.random.default_rng(pattern_seed)
        pat = prng.normal(0, class_patterns, size=(n_classes, *row_shape)).astype(np.float32)
    images = np.empty((n, *row_shape), np.float32)
    rows = max(1, _DRAW_CHUNK_BYTES // (8 * size * size * channels))
    for start in range(0, n, rows):
        chunk = images[start:start + rows]
        chunk[...] = rng.normal(0, 0.1, size=chunk.shape)
        chunk += code[start:start + rows]
        if pat is not None:
            chunk += pat[targets[start:start + rows]]
    return ArrayDataset(images, targets, num_classes=n_classes)
