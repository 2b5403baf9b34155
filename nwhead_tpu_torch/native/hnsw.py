"""ctypes binding of the port's C++ HNSW index (the hnsw eval mode).

Port of ``nwhead_tpu/native/hnsw.py``. ``hnsw.cpp`` beside this file (the
port's own copy of the JAX package's source) is compiled at first use with
``g++ -O3 -march=native -shared -fPIC -std=c++17`` into
``nwhead_tpu_torch/build/``, the library named by a hash of the source and
the flags and written by an atomic rename, as ``ops/_cuda.py`` builds the
CUDA kernels. A build or load that fails raises with the compiler's error:
nothing falls back to exact k-NN.

The graph lives on the host and is built from a host copy of the bank,
taken once. ``index(x)`` copies the queries to the host, searches, and
gathers the neighbours' features and labels from the bank on its device by
the ids (one small copy of ids a call, never the bank). It returns the
flat union ``(B * k, D)``, ``(B * k,)`` that the NW head shares across the
batch (the reference's quirk, ``nwhead/utils.py:214-215``).
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
from typing import Optional, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops._cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "hnsw.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P_F32 = ctypes.POINTER(ctypes.c_float)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_API = {
    "hnsw_create": ([ctypes.c_int] * 4 + [ctypes.c_uint], ctypes.c_void_p),
    "hnsw_add_items": ([ctypes.c_void_p, _P_F32, ctypes.c_int, ctypes.c_int], None),
    "hnsw_search": ([ctypes.c_void_p, _P_F32] + [ctypes.c_int] * 4 + [_P_I64], None),
    "hnsw_size": ([ctypes.c_void_p], ctypes.c_int),
    "hnsw_free": ([ctypes.c_void_p], None),
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhnsw_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``hnsw.cpp`` unless its library is already built; returns
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when ``g++`` is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the HNSW index cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
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


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


class HNSWIndex:
    """L2 HNSW over a support bank ``data (S, D)`` with ``labels (S,)``
    (``M=16``, ``ef_construction=100``: the reference's parameters,
    ``utils.py:206``; ``ef_search`` defaults to ``max(64, n_neighbors)``).
    ``data`` may be a tensor on any device: the graph is built from its host
    copy, and the features of each answer are gathered from ``data`` itself."""

    def __init__(self, data, labels, n_neighbors: int = 20, M: int = 16,
                 ef_construction: int = 100, ef_search: Optional[int] = None,
                 seed: int = 100) -> None:
        lib = load_library()
        self.data = torch.as_tensor(data)
        self.labels = torch.as_tensor(labels, device=self.data.device)
        self.n_neighbors = n_neighbors
        self.ef_search = ef_search if ef_search is not None else max(64, n_neighbors)
        host = _host_f32(self.data)
        if host.ndim != 2 or 0 in host.shape:
            raise ValueError(f"expected a non-empty (S, D) bank, got {host.shape}")
        n, self.dim = host.shape
        self._handle = lib.hnsw_create(self.dim, n, M, ef_construction, seed)
        self._free = weakref.finalize(self, lib.hnsw_free, self._handle)
        lib.hnsw_add_items(self._handle, host.ctypes.data_as(_P_F32), n, self.dim)

    def __len__(self) -> int:
        return load_library().hnsw_size(self._handle)

    def add_items(self, data, labels) -> None:
        """Insert new rows online (the graph grows by the same insertion path
        the build takes; no rebuild) and append them to the bank."""
        new = torch.as_tensor(data)
        host = _host_f32(new)
        if host.ndim != 2 or host.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) features, got {host.shape}")
        load_library().hnsw_add_items(self._handle, host.ctypes.data_as(_P_F32),
                                      host.shape[0], self.dim)
        dev = self.data.device
        self.data = torch.cat([self.data, new.to(dev, self.data.dtype)])
        self.labels = torch.cat([self.labels,
                                 torch.as_tensor(labels, device=dev).to(self.labels.dtype)])

    def knn_query(self, x, k: Optional[int] = None) -> np.ndarray:
        """Neighbour ids ``(B, k)`` int64 on the host, nearest first."""
        k = k or self.n_neighbors
        q = _host_f32(x)
        if q.ndim != 2 or q.shape[1] != self.dim or k < 1:
            raise ValueError(f"expected (B, {self.dim}) queries and k >= 1, got {q.shape}, k={k}")
        out = np.empty((q.shape[0], k), dtype=np.int64)
        load_library().hnsw_search(self._handle, q.ctypes.data_as(_P_F32), q.shape[0],
                                   self.dim, k, max(self.ef_search, k),
                                   out.ctypes.data_as(_P_I64))
        return out

    def __call__(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """The flat union of the batch's neighbour sets, from the bank's device.
        A search that finds fewer than ``n_neighbors`` rows (a bank smaller
        than k) raises, where the JAX package would index row -1."""
        ids = self.knn_query(x).reshape(-1)
        if ids.min(initial=0) < 0:
            raise ValueError(f"the HNSW search found fewer than k={self.n_neighbors} "
                             f"neighbours in a bank of {len(self)} rows")
        flat = torch.from_numpy(ids).to(self.data.device)
        return self.data[flat], self.labels[flat]
