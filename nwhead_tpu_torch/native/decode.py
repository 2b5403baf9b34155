"""ctypes binding of the port's C++ JPEG decode pool.

Port of ``nwhead_tpu/native/decode.py``. ``decode.cpp`` beside this file
(the port's own copy of the JAX package's source) is compiled at first use
with ``g++ -O3 -march=native -shared -fPIC -std=c++17 ... -ljpeg -lpthread``
into ``nwhead_tpu_torch/build/``, the library named by a hash of the source
and the flags and written by an atomic rename, as ``native/hnsw.py`` builds
its library. A build or load that fails raises ``RuntimeError`` with the
compiler's output: it needs ``g++`` and libjpeg's headers and library, and
nothing falls back to another decoder.

Decoding runs in the pool's C++ threads, each with its own libjpeg
decompressor, straight into numpy buffers:

* ``JpegDecodePool.decode_batch(paths)``: whole images at their own size;
* ``JpegDecodePool.decode_crop_resize(paths, boxes, out_hw, flips)``:
  decode + crop + bilinear resize (+ horizontal flip, in the resize's
  stores) into one ``(n, H, W, 3)`` uint8 batch, libjpeg's IDCT scaling
  taking the smallest scale that covers the output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nwhead_tpu_torch.ops._cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "decode.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_INT = ctypes.POINTER(ctypes.c_int)
_API = {
    "jpeg_dims": ([ctypes.c_char_p, _P_INT, _P_INT], ctypes.c_int),
    "decode_pool_create": ([ctypes.c_int], ctypes.c_void_p),
    "decode_pool_free": ([ctypes.c_void_p], None),
    # pool, paths, boxes (n, 4) or NULL, flips (n,) or NULL, n, H, W, out
    "decode_pool_run": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), _P_INT, _P_U8,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P_U8], ctypes.c_int),
    # pool, paths, n, per-image outputs, heights, widths
    "decode_pool_run_varied": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.POINTER(_P_U8), _P_INT, _P_INT], ctypes.c_int),
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libjpegpool_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``decode.cpp`` unless its library is already built; returns
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when ``g++`` is missing or fails (libjpeg's ``jpeglib.h`` and
    ``libjpeg.so`` are needed)."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the libjpeg decode pool cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} against libjpeg "
                           f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load the library once per process and declare its C API."""
    lib = ctypes.CDLL(str(build()))
    for fn, (argtypes, restype) in _API.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def jpeg_dims(path: str) -> Tuple[int, int]:
    """``(h, w)`` from the JPEG's header alone."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if load_library().jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"failed to read JPEG header: {path}")
    return h.value, w.value


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


class JpegDecodePool:
    """A pool of ``workers`` native JPEG decoder threads (freed with the
    object)."""

    def __init__(self, workers: int = 8) -> None:
        lib = load_library()
        self.workers = max(1, workers)
        self._handle = lib.decode_pool_create(self.workers)
        self._free = weakref.finalize(self, lib.decode_pool_free, self._handle)

    def decode_batch(self, paths: Sequence[str]) -> List[np.ndarray]:
        """Whole images at their own size: a list of (h, w, 3) RGB uint8."""
        n = len(paths)
        dims = [jpeg_dims(p) for p in paths]
        bufs = [np.empty((h, w, 3), np.uint8) for h, w in dims]
        outs = (_P_U8 * n)(*[b.ctypes.data_as(_P_U8) for b in bufs])
        hs = (ctypes.c_int * n)(*[d[0] for d in dims])
        ws = (ctypes.c_int * n)(*[d[1] for d in dims])
        fails = load_library().decode_pool_run_varied(self._handle, _paths_array(paths), n,
                                                      outs, hs, ws)
        if fails:
            raise IOError(f"{fails} of {n} JPEGs failed to decode")
        return bufs

    def decode_crop_resize(self, paths: Sequence[str], boxes: Optional[np.ndarray],
                           out_hw: Tuple[int, int], flips=None) -> np.ndarray:
        """Decode + crop + resize (+ flip): ``boxes`` (n, 4) int32 ``(y, x,
        h, w)`` in the source's coordinates (None: whole images), ``flips``
        an optional per-image bool sequence (a mirror in the resize's
        stores); returns (n, out_h, out_w, 3) uint8."""
        n = len(paths)
        out_h, out_w = out_hw
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        boxes_ptr = flips_ptr = None
        if boxes is not None:
            boxes = np.ascontiguousarray(boxes, np.int32)
            if boxes.shape != (n, 4):
                raise ValueError(f"boxes must be ({n}, 4), got {boxes.shape}")
            boxes_ptr = boxes.ctypes.data_as(_P_INT)
        if flips is not None:
            flips = np.ascontiguousarray(np.asarray(flips, np.uint8).reshape(-1))
            if flips.shape != (n,):
                raise ValueError(f"flips must have {n} entries, got {flips.shape}")
            flips_ptr = flips.ctypes.data_as(_P_U8)
        fails = load_library().decode_pool_run(self._handle, _paths_array(paths), boxes_ptr,
                                               flips_ptr, n, out_h, out_w,
                                               out.ctypes.data_as(_P_U8))
        if fails:
            raise IOError(f"{fails} of {n} JPEGs failed to decode")
        return out
