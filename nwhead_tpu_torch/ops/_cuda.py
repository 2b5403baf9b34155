"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and becomes its own
shared library, compiled with ``nvcc`` for ``sm_90a`` into
``nwhead_tpu_torch/build/`` at first use and loaded with ``ctypes``. Every
pointer and the stream pass as ``c_void_p``. The libraries are named by one
hash of all of ``csrc/`` (``*.cu`` and the shared ``*.cuh`` headers) and the
flags, so an edit to any source or header rebuilds them. A build starts one
``nvcc`` per source, all at once.

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
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_VP, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# library -> {C function: (argtypes, restype)}
_API = {
    "vit_attn": {
        "vit_attention_forward": ([_VP, _VP] + [_I32] * 4 + [_F32, _I32, _VP], _I32),
        "vit_attention_forward_strided": ([_VP] * 4 + [_I32] * 4 + [_I64] * 6 + [_F32, _I32, _VP],
                                          _I32),
        "vit_attention_block_bf16": (
            [_VP] * 3 + [_F32] + [_VP] * 5 + [_I32] + [_VP] * 3 + [_I32] * 4 + [_F32, _VP],
            _I32),
        "vit_attention_block_int8": (
            [_VP] * 3 + [_F32] + [_VP] * 3 + [_F32] * 2 + [_VP] * 3 + [_F32] * 2 + [_VP, _I32]
            + [_VP] * 3 + [_I32] * 4 + [_F32, _VP], _I32),
        "vit_attn_error_string": ([_I32], ctypes.c_char_p),
    },
    "vit_attn_bwd": {
        "vit_attention_backward": ([_VP] * 4 + [_I32] * 4 + [_F32, _I32, _VP], _I32),
        "vit_attn_bwd_error_string": ([_I32], ctypes.c_char_p),
    },
    "vit_mlp_bwd": {
        "vit_mlp_backward": ([_VP] * 13 + [_I32] * 7 + [_VP], _I32),
        "vit_mlp_bwd_splits": ([_I32] * 4, _I32),
        "vit_mlp_bwd_error_string": ([_I32], ctypes.c_char_p),
    },
    "vit_mlp": {
        "vit_mlp_forward": ([_VP] * 6 + [_I32] * 5 + [_VP], _I32),
        "vit_mlp_block_forward": ([_VP] * 3 + [_F32] + [_VP] * 5 + [_I32, _VP] + [_I32] * 4
                                  + [_VP], _I32),
        "vit_mlp_int8_forward": ([_VP] * 3 + [_F32] + [_VP] * 3 + [_F32] * 2 + [_VP] * 3
                                 + [_F32] * 2 + [_VP, _I32, _VP] + [_I32] * 4 + [_VP], _I32),
        "vit_mlp_max_out": ([], _I32),
        "vit_mlp_error_string": ([_I32], ctypes.c_char_p),
    },
    "nw_prepared": {
        "nw_prepared_forward": ([_VP] * 11 + [_I32] * 9 + [_VP], _I32),
        "nw_prepared_quant_forward": ([_VP] * 12 + [_I32] * 9 + [_VP], _I32),
        "nw_prepared_sel_forward": ([_VP] * 14 + [_I32] * 11 + [_VP], _I32),
        "nw_prepared_query_tile": ([], _I32),
        "nw_prepared_support_tile": ([], _I32),
        "nw_prepared_smem_bytes": ([_I32], _I32),
        "nw_prepared_max_classes": ([_I32], _I32),
        "nw_prepared_error_string": ([_I32], ctypes.c_char_p),
    },
    "nw_fused": {
        "nw_fused_forward": ([_VP] * 10 + [_I32] * 9 + [_VP], _I32),
        "nw_fused_bwd_dq": ([_VP] * 11 + [_I32] * 8 + [_VP], _I32),
        "nw_fused_bwd_ds": ([_VP] * 9 + [_I32] * 6 + [_VP], _I32),
        "nw_fused_query_tile": ([], _I32),
        "nw_fused_support_tile": ([], _I32),
        "nw_fused_max_classes": ([_I32], _I32),
        "nw_fused_dq_max_features": ([_I32], _I32),
        "nw_fused_ds_max_batch": ([_I32], _I32),
        "nw_fused_smem_bytes": ([_I32, _I32], _I32),
        "nw_fused_error_string": ([_I32], ctypes.c_char_p),
    },
    "lab_stream": {
        "lab_stream_reduce": ([_VP] * 3 + [_I32] * 6 + [_VP], _I32),
        "lab_stream_max_chunk_bytes": ([], _I32),
        "lab_stream_error_string": ([_I32], ctypes.c_char_p),
    },
    "lab_nw": {
        "lab_fused_variant": ([_VP] * 9 + [_I32] * 9 + [_VP], _I32),
        "lab_manual_fused": ([_VP] * 8 + [_I32] * 6 + [_VP], _I32),
        "lab_nw_query_tile": ([], _I32),
        "lab_variant_smem_bytes": ([_I32, _I32], _I32),
        "lab_manual_smem_bytes": ([_I32] * 3, _I32),
        "lab_optin_smem": ([_I32], _I32),
        "lab_nw_error_string": ([_I32], ctypes.c_char_p),
    },
    "lab_blocks": {
        "lab_fused_blocks": ([_VP] * 4 + [_I32] * 5 + [_VP], _I32),
        "lab_blocks_error_string": ([_I32], ctypes.c_char_p),
    },
}


def find_nvcc() -> Optional[str]:
    """``nvcc`` from ``PATH``, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return None


def sources() -> List[Path]:
    """The ``.cu`` sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str = "nw_prepared") -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build() -> Dict[str, dict]:
    """Compile every library whose build for the current sources is missing,
    one ``nvcc`` per source, all started together. Returns, per library,
    its path, whether it was cached, the seconds its compile took, and
    ``ptxas -v``'s report (registers, shared memory, spills)."""
    out: Dict[str, dict] = {}
    todo = []
    for src in sources():
        path = library_path(src.stem)
        log = path.with_suffix(".ptxas.txt")
        if path.exists():
            out[src.stem] = {"path": str(path), "cached": True, "seconds": 0.0,
                             "ptxas": log.read_text() if log.exists() else ""}
        else:
            todo.append((src, path, log))
    if not todo:
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, path, log in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, path, log, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for src, path, log, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} ({proc.returncode}):\n{stdout}\n{stderr}")
            continue
        log.write_text(stdout + stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        out[src.stem] = {"path": str(path), "cached": False, "seconds": seconds,
                         "ptxas": stdout + stderr}
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str = "nw_prepared") -> ctypes.CDLL:
    """Build if needed, load ``lib<name>`` once per process, and declare
    its C API."""
    if name not in _API:
        raise ValueError(f"no kernel library {name!r} (have {sorted(_API)})")
    build()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in _API[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
