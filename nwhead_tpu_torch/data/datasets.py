"""Datasets of the port: in-memory arrays and image files on disk.

Port of ``nwhead_tpu/data/datasets.py``. The dataset protocol is the JAX
package's: ``.targets``, ``.num_classes``, ``gather(indices) -> (n, H, W,
C) float32`` (uint8 from a ``device_normalize`` transform) and ``__len__``.

* ``ArrayDataset`` over (N, H, W, C) arrays, with an optional per-image
  transform (CIFAR's ``.npy`` files, the synthetic sets, sklearn's digits);
* ``ImageFileDataset`` over image files, decoded at ``gather`` time by
  ``decoder``: ``"pil"`` (PIL, on ``workers`` threads), ``"native"`` (the
  port's C++ libjpeg pool, ``native/decode.py``, then the transform) or
  ``"native_fused"`` (the pool decodes, crops and resizes in one pass for
  the imagenet transforms, whose box and flip it draws first). A batch with
  a file that is not a ``.jpg``/``.jpeg`` goes through PIL, and a batch
  that libjpeg fails to decode is decoded again by PIL, as in the JAX
  package; a decode pool that cannot be built raises.
* The parsers of the fine-grained sets, with the reference's splits:
  CUB-200-2011 (``train_test_split.txt`` / ``images.txt`` /
  ``image_class_labels.txt``, split 0 is train), Stanford Dogs
  (``{train,test}_list.csv``), Oxford Flowers-102 (``imagelabels.mat``,
  ``setid.mat``) and FGVC-Aircraft (``images_variant_{split}.txt``,
  ``variants.txt``); labels from 0.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from nwhead_tpu_torch.data.transforms import to_float

DECODERS = ("native", "native_fused", "pil")

# make_synthetic_dataset draws its noise in row chunks of about this many
# float64 bytes, so a CUB-sized set (3.6 GB of f32) needs no 7.2 GB float64
# temporary. Chunked draws from one Generator equal a single draw.
_DRAW_CHUNK_BYTES = 64 << 20


class ArrayDataset:
    """In-memory dataset over (N, H, W, C) arrays; ``transform`` (a
    ``data.transforms.Transform``) applies to each gathered image."""

    def __init__(
        self,
        images: np.ndarray,
        targets: Sequence[int],
        num_classes: Optional[int] = None,
        transform: Optional[Callable] = None,
    ) -> None:
        if len(images) != len(targets):
            raise ValueError(f"{len(images)} images for {len(targets)} targets")
        self.images = images
        self.targets = np.asarray(targets)
        self.num_classes = (
            num_classes if num_classes is not None else int(self.targets.max()) + 1
        )
        self.transform = transform

    def __len__(self) -> int:
        return len(self.images)

    def gather(self, indices) -> np.ndarray:
        indices = np.asarray(indices)
        if self.transform is None:
            return self.images[indices].astype(np.float32)
        return np.stack([self.transform(self.images[i]) for i in indices])


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


class ImageFileDataset:
    """Images in files, decoded and transformed at ``gather`` time (see the
    module's docstring for the decoders). ``workers`` is the decode pool's
    thread count, and the PIL path's; with more than one PIL thread, which
    thread draws a random transform's numbers is not fixed."""

    def __init__(
        self,
        paths: Sequence[str],
        targets: Sequence[int],
        num_classes: int,
        transform: Optional[Callable] = None,
        workers: int = 8,
        decoder: str = "native",
    ) -> None:
        if len(paths) != len(targets):
            raise ValueError(f"{len(paths)} paths for {len(targets)} targets")
        if decoder not in DECODERS:
            raise ValueError(f"decoder {decoder!r}: expected one of {DECODERS}")
        self.paths = list(paths)
        self.targets = np.asarray(targets)
        self.num_classes = num_classes
        self.transform = transform
        self.workers = workers
        self.decoder = decoder
        self._pool = None  # the PIL path's thread pool
        self._native_pool = None

    def __len__(self) -> int:
        return len(self.paths)

    def _native(self):
        """The C++ decode pool, built at first use; a failed build raises."""
        if self._native_pool is None:
            from nwhead_tpu_torch.native.decode import JpegDecodePool

            self._native_pool = JpegDecodePool(max(1, self.workers))
        return self._native_pool

    def _apply_transform(self, img: np.ndarray) -> np.ndarray:
        return self.transform(img) if self.transform is not None else to_float(img)

    def _load(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.paths[idx]) as im:
            img = np.asarray(im.convert("RGB"))
        return self._apply_transform(img)

    def gather(self, indices) -> np.ndarray:
        idx_list = [int(i) for i in np.asarray(indices)]
        if idx_list and self.decoder == "native_fused":
            out = self._gather_fused(idx_list)
            if out is not None:
                return out
        if idx_list and self.decoder != "pil" and all(_is_jpeg(self.paths[i])
                                                      for i in idx_list):
            pool = self._native()
            try:
                raw = pool.decode_batch([self.paths[i] for i in idx_list])
            except OSError:
                pass  # a file libjpeg rejects: the batch goes through PIL
            else:
                return np.stack([self._apply_transform(r) for r in raw])
        if self.workers > 1 and len(idx_list) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            return np.stack(list(self._pool.map(self._load, idx_list)))
        return np.stack([self._load(i) for i in idx_list])

    def _gather_fused(self, idx_list: List[int]) -> Optional[np.ndarray]:
        """``decoder='native_fused'``: decode + crop + resize in one native
        pass when the transform is a crop box + resize (the imagenet kinds)
        and every file is a JPEG; None otherwise, or when libjpeg rejects a
        file (the boxes and flips are drawn by then, as in the JAX
        package). Its bilinear resize is not PIL's antialiased one: the
        pixels differ from the ``pil`` and ``native`` decoders'."""
        t = self.transform
        paths = [self.paths[i] for i in idx_list]
        if (t is None or not getattr(t, "supports_fused_decode", False)
                or not all(_is_jpeg(p) for p in paths)):
            return None
        from nwhead_tpu_torch.native.decode import jpeg_dims

        pool = self._native()
        try:
            boxes, flips = [], []
            for p in paths:
                box, flip = t.crop_geometry(*jpeg_dims(p))
                boxes.append(box)
                flips.append(flip)
            batch = pool.decode_crop_resize(paths, np.asarray(boxes, np.int32),
                                            (t.size, t.size), flips=flips)
        except OSError:
            return None
        return t.finish_batch(batch, None)


def _read_two_column(path: str):
    """Whitespace-separated ``id value`` lines -> (ids, values)."""
    ids, vals = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            a, b = line.split(None, 1)
            ids.append(int(a))
            vals.append(b.strip())
    return ids, vals


class Cub200Dataset(ImageFileDataset):
    """CUB-200-2011 under ``root_path`` (``images/``, the three manifests);
    split 0 is train, labels shifted to 0."""

    def __init__(self, root_path: str, is_train: bool, transform=None, workers: int = 8,
                 decoder: str = "native") -> None:
        split_ids, split_vals = _read_two_column(os.path.join(root_path, "train_test_split.txt"))
        img_ids, img_paths = _read_two_column(os.path.join(root_path, "images.txt"))
        lbl_ids, lbl_vals = _read_two_column(os.path.join(root_path, "image_class_labels.txt"))
        want = 0 if is_train else 1
        keep = {i for i, s in zip(split_ids, split_vals) if int(s) == want}
        paths = [os.path.join(root_path, "images", p) for i, p in zip(img_ids, img_paths)
                 if i in keep]
        targets = [int(v) - 1 for i, v in zip(lbl_ids, lbl_vals) if i in keep]
        super().__init__(paths, targets, num_classes=200, transform=transform, workers=workers,
                         decoder=decoder)


class StanfordDogDataset(ImageFileDataset):
    """Stanford Dogs under ``root_path``: ``{train,test}_list.csv`` rows of
    ``path,label`` (labels from 1) and ``Images/``."""

    def __init__(self, root_path: str, is_train: bool, transform=None, workers: int = 8,
                 decoder: str = "native") -> None:
        name = "train_list.csv" if is_train else "test_list.csv"
        paths, targets = [], []
        with open(os.path.join(root_path, name)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                p, lbl = line.rsplit(",", 1)
                paths.append(os.path.join(root_path, "Images", p))
                targets.append(int(lbl) - 1)
        super().__init__(paths, targets, num_classes=120, transform=transform, workers=workers,
                         decoder=decoder)


class Flowers102Dataset(ImageFileDataset):
    """Oxford Flowers-102 under ``root_path``: ``jpg/image_XXXXX.jpg``,
    ``imagelabels.mat`` and ``setid.mat`` (splits train, val, test; read
    with scipy, imported only here)."""

    def __init__(self, root_path: str, split: str = "train", transform=None, workers: int = 8,
                 decoder: str = "native") -> None:
        from scipy.io import loadmat

        labels = loadmat(os.path.join(root_path, "imagelabels.mat"))["labels"][0]
        setid = loadmat(os.path.join(root_path, "setid.mat"))
        ids = {"train": setid["trnid"][0], "val": setid["valid"][0],
               "test": setid["tstid"][0]}[split]
        paths = [os.path.join(root_path, "jpg", f"image_{i:05d}.jpg") for i in ids]
        targets = [int(labels[i - 1]) - 1 for i in ids]
        super().__init__(paths, targets, num_classes=102, transform=transform, workers=workers,
                         decoder=decoder)


class FGVCAircraftDataset(ImageFileDataset):
    """FGVC-Aircraft variants under ``root_path``: ``data/images/*.jpg``,
    ``data/images_variant_{split}.txt`` (splits train, val, trainval, test)
    and ``data/variants.txt`` (the class order)."""

    def __init__(self, root_path: str, split: str = "trainval", transform=None,
                 workers: int = 8, decoder: str = "native") -> None:
        data_dir = os.path.join(root_path, "data")
        with open(os.path.join(data_dir, "variants.txt")) as f:
            variants = [v.strip() for v in f if v.strip()]
        v2id = {v: i for i, v in enumerate(variants)}
        paths, targets = [], []
        with open(os.path.join(data_dir, f"images_variant_{split}.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                img_id, variant = line.split(" ", 1)
                paths.append(os.path.join(data_dir, "images", f"{img_id}.jpg"))
                targets.append(v2id[variant])
        super().__init__(paths, targets, num_classes=len(variants), transform=transform,
                         workers=workers, decoder=decoder)


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
