"""Build and load the package's CUDA kernels.

``csrc/nw_prepared.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``nwhead_tpu_torch/build/`` at first use, named
by a hash of the source and the flags (so an edited source rebuilds), and
loaded with ``ctypes``. Every pointer and the stream pass as ``c_void_p``.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nw_prepared.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


def find_nvcc() -> Optional[str]:
    """``nvcc`` from ``PATH``, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnw_prepared_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernel library unless this source's build exists.
    Returns the path, whether it was cached, the seconds the compile took,
    and ``ptxas -v``'s report (registers, shared memory, spills)."""
    path = library_path()
    log = path.with_suffix(".ptxas.txt")
    if path.exists():
        return {"path": str(path), "cached": True, "seconds": 0.0,
                "ptxas": log.read_text() if log.exists() else ""}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(path), "cached": False, "seconds": seconds,
            "ptxas": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C API."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nw_prepared_forward.argtypes = [vp] * 9 + [i32] * 8 + [vp]
    lib.nw_prepared_forward.restype = i32
    lib.nw_prepared_query_tile.argtypes = []
    lib.nw_prepared_query_tile.restype = i32
    lib.nw_prepared_support_tile.argtypes = []
    lib.nw_prepared_support_tile.restype = i32
    lib.nw_prepared_smem_bytes.argtypes = [i32]
    lib.nw_prepared_smem_bytes.restype = i32
    lib.nw_prepared_max_classes.argtypes = [i32]
    lib.nw_prepared_max_classes.restype = i32
    lib.nw_prepared_error_string.argtypes = [i32]
    lib.nw_prepared_error_string.restype = ctypes.c_char_p
    return lib
