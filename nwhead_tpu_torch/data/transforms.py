"""Image transforms of the input pipeline, on the host in numpy.

Port of ``nwhead_tpu/data/transforms.py`` (the port's own copy; it imports
nothing of the JAX package). The reference's torchvision pipelines:

* ImageNet-style train: RandomResizedCrop(224) + RandomHorizontalFlip +
  normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225));
* ImageNet-style eval: Resize(256) + CenterCrop(224) + normalize;
* CIFAR train: RandomCrop(32, padding=4) + flip + normalize
  (mean=(0.4914, 0.4822, 0.4465), std=(0.2023, 0.1994, 0.2010));
* CIFAR eval: normalize only.

Images are HWC, the result float32 HWC. Randomness comes from a
``numpy.random.Generator`` per thread, spawned from the transform's
``SeedSequence``: the same seed, thread and call order give the same draws
as the JAX package's transform. Resizes go through PIL (imported only
there). ``device_normalize=True`` stops after the geometric ops and returns
uint8, which ``device_normalize_fn`` normalizes on the batch's device.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (ToTensor's scaling)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _resize_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to ``size`` (h, w) by PIL (antialiased, as
    torchvision's); a float image goes through uint8 and back."""
    from PIL import Image

    arr = img if img.dtype == np.uint8 else np.clip(img * 255.0, 0, 255).astype(np.uint8)
    out = np.asarray(Image.fromarray(arr).resize((size[1], size[0]), Image.BILINEAR))
    if img.dtype != np.uint8:
        out = out.astype(np.float32) / 255.0
    return out


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``Resize(size)``: the shorter side becomes ``size``."""
    h, w = img.shape[:2]
    if h <= w:
        new_h, new_w = size, max(1, int(round(w * size / h)))
    else:
        new_h, new_w = max(1, int(round(h * size / w))), size
    return _resize_pil(img, (new_h, new_w))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return img[top:top + size, left:left + size]


def sample_rrc_box(
    h: int,
    w: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision ``RandomResizedCrop``'s box: ``(top, left, ch, cw)``,
    ten tries, then a centred crop of an aspect within ``ratio``."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def center_eval_box(h: int, w: int, size: int = 224) -> Tuple[int, int, int, int]:
    """The box in the source image's coordinates that Resize(short = size *
    256/224) + CenterCrop(size) keeps: a centred square of side short *
    224/256 (up to rounding)."""
    side = int(round(min(h, w) * size / (size * 256 / 224)))
    side = max(1, min(side, min(h, w)))
    return (h - side) // 2, (w - side) // 2, side, side


def random_resized_crop(
    img: np.ndarray,
    rng: np.random.Generator,
    size: int = 224,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """torchvision ``RandomResizedCrop``: a ``sample_rrc_box`` crop resized
    to (size, size)."""
    top, left, ch, cw = sample_rrc_box(img.shape[0], img.shape[1], rng, scale, ratio)
    return _resize_pil(img[top:top + ch, left:left + cw], (size, size))


def random_crop_padded(img: np.ndarray, rng: np.random.Generator, size: int = 32,
                       padding: int = 4) -> np.ndarray:
    """CIFAR ``RandomCrop(32, padding=4)``: zero-pad, then a random crop."""
    padded = np.pad(img, ((padding, padding), (padding, padding), (0, 0)), mode="constant")
    top = int(rng.integers(0, 2 * padding + 1))
    left = int(rng.integers(0, 2 * padding + 1))
    return padded[top:top + size, left:left + size]


@dataclass
class Transform:
    """One of the four pipelines (``kind``: ``imagenet_train``,
    ``imagenet_eval``, ``cifar_train``, ``cifar_eval``), called on one HWC
    uint8 or float image. Each thread that calls it draws from its own
    generator, spawned from ``SeedSequence(seed)`` in the order threads
    first call it."""

    kind: str
    size: int = 224
    mean: Sequence[float] = IMAGENET_MEAN
    std: Sequence[float] = IMAGENET_STD
    seed: Optional[int] = None
    # Stop after the geometric ops and return uint8 (4x fewer bytes to the
    # device); ``device_normalize_fn`` normalizes there.
    device_normalize: bool = False

    def __post_init__(self):
        self._seed_seq = np.random.SeedSequence(self.seed)
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def rng(self) -> np.random.Generator:
        if not hasattr(self._local, "rng"):
            with self._lock:
                self._local.rng = np.random.default_rng(self._seed_seq.spawn(1)[0])
        return self._local.rng

    # The imagenet kinds are a crop box + resize (+ flip + normalize), which
    # the native decoder does in one pass (``decoder='native_fused'``):
    # ``crop_geometry`` draws each image's box and flip, ``finish_batch``
    # flips and normalizes the decoded batch.

    @property
    def supports_fused_decode(self) -> bool:
        return self.kind in ("imagenet_train", "imagenet_eval")

    def crop_geometry(self, h: int, w: int):
        """``((top, left, ch, cw), flip)`` for an (h, w) source image."""
        if self.kind == "imagenet_train":
            box = sample_rrc_box(h, w, self.rng)
            return box, bool(self.rng.random() < 0.5)
        if self.kind == "imagenet_eval":
            return center_eval_box(h, w, self.size), False
        raise ValueError(f"{self.kind} is not expressible as crop+resize")

    def finish_batch(self, batch_u8: np.ndarray, flips=None) -> np.ndarray:
        """(n, size, size, 3) uint8 -> normalized float32 (uint8 with
        ``device_normalize``). ``flips=None``: the decoder applied them;
        else each true entry mirrors its image here. Normalizes in place of
        one float32 copy."""
        if flips is not None:
            for i, f in enumerate(flips):
                if f:
                    batch_u8[i] = batch_u8[i, :, ::-1].copy()
        if self.device_normalize:
            return batch_u8
        out = batch_u8.astype(np.float32)
        out *= np.float32(1.0 / 255.0)
        out -= np.asarray(self.mean, np.float32)
        out /= np.asarray(self.std, np.float32)
        return out

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.kind == "imagenet_train":
            img = random_resized_crop(img, self.rng, self.size)
            if self.rng.random() < 0.5:
                img = img[:, ::-1]
        elif self.kind == "imagenet_eval":
            img = center_crop(resize_shorter_side(img, int(self.size * 256 / 224)), self.size)
        elif self.kind == "cifar_train":
            img = random_crop_padded(img, self.rng, self.size)
            if self.rng.random() < 0.5:
                img = img[:, ::-1]
        elif self.kind != "cifar_eval":
            raise ValueError(self.kind)
        img = np.ascontiguousarray(img)
        if self.device_normalize:
            return img
        return normalize(to_float(img), self.mean, self.std)


def device_normalize_fn(mean: Sequence[float] = IMAGENET_MEAN,
                        std: Sequence[float] = IMAGENET_STD):
    """``u8 batch -> (u8/255 - mean)/std`` in float32 on the batch's own
    device, for the uint8 batches of a ``device_normalize=True`` transform.
    Plain torch: the JAX package's version is a jitted XLA op, not a
    kernel."""
    import torch

    m = torch.tensor(mean, dtype=torch.float32)
    s = torch.tensor(std, dtype=torch.float32)

    def f(u8: "torch.Tensor") -> "torch.Tensor":
        return (u8.to(torch.float32) * (1.0 / 255.0) - m.to(u8.device)) / s.to(u8.device)

    return f


def imagenet_train_transform(size: int = 224, seed: Optional[int] = None,
                             device_normalize: bool = False) -> Transform:
    return Transform("imagenet_train", size, IMAGENET_MEAN, IMAGENET_STD, seed, device_normalize)


def imagenet_eval_transform(size: int = 224, seed: Optional[int] = None,
                            device_normalize: bool = False) -> Transform:
    return Transform("imagenet_eval", size, IMAGENET_MEAN, IMAGENET_STD, seed, device_normalize)


def cifar_train_transform(seed: Optional[int] = None) -> Transform:
    return Transform("cifar_train", 32, CIFAR_MEAN, CIFAR_STD, seed)


def cifar_eval_transform(seed: Optional[int] = None) -> Transform:
    return Transform("cifar_eval", 32, CIFAR_MEAN, CIFAR_STD, seed)
