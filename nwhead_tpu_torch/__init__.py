"""nwhead_tpu_torch — the Nadaraya-Watson head framework in PyTorch and CUDA.

Port of ``nwhead_tpu/__init__.py`` for one NVIDIA Hopper GPU. The JAX package
``nwhead_tpu`` stays the reference; this package imports neither it nor jax.
Plain tensor code is PyTorch; the fused NW head and the ViT's fused layers
run on CUDA kernels written for ``sm_90a`` (``csrc/nw_fused.cu``: the raw
forward K1 and its backward K3; ``csrc/nw_prepared.cu``: the prepared-bank
forward K2, its int8/int4 modes K4/K5 and its tile-selected pass K6, each
also unfinalized (``partials=True``, as is K1); ``csrc/vit_attn.cu``: ViT
attention K7 (and K12, attention over separate q, k, v, through it) and
the bf16 attention half-block K10; ``csrc/vit_attn_bwd.cu``: K7's backward K8;
``csrc/vit_mlp.cu``: the fused MLP forward K9 and the bf16 MLP half-block
K11; ``csrc/vit_mlp_bwd.cu``: the K9 backward), built with ``nvcc`` at
first use and bound with ``ctypes`` (``ops/_cuda.py``).

The slices ported so far: episodic training (``python -m
nwhead_tpu_torch.train``: ResNet or ViT featurizer -> ``NWModel.forward``
-> fused head K1/K3 -> ``NWTrainer``; a ViT with the fused impls trains on
K7/K8 and the K9 forward and backward) and serving (``NWNet.precompute`` ->
``prepare_support`` -> ``NWNet.make_serving_fn``, K2) with a ResNet or a ViT
featurizer (``--fused_inference``: K7/K9; ``NWNet.fuse_featurizer``, the
bf16 serving graph: K10/K11), int8/int4 banks (K4/K5) and IVF-pruned
serving (``ops/ivf.py``, ``--serve_mode ivf``: K6 over the bank tiles a
batch routes to), support-sharded serving (``parallel``: a bank split over
a mesh's devices, each shard's partials merged exactly; ``NWNet(mesh=...)``,
``--mesh``) and a host-resident bank streamed in chunks
(``nw/streaming.py``).

The kernel labs and the HBM yardstick (``labs``, loaded on first use:
``python -m nwhead_tpu_torch.labs.<lab>``) run K13/L4 ``stream`` and L1
``stream_reduce`` (``csrc/lab_stream.cu``), L1 ``fused_variant`` and L3
``manual_fused`` (``csrc/lab_nw.cu``) and L2 ``fused_blocks``
(``csrc/lab_blocks.cu``).
"""

__version__ = "0.1.0"

from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES, get_kernel
from nwhead_tpu_torch.ops.nw import nw_log_probs


def capabilities() -> dict:
    """What this process can run: torch and CUDA versions, the visible CUDA
    devices, ``nvcc``, and which kernel libraries are already built for the
    current sources, and the labs' kernels with their libraries. A CPU-only
    process reports no device."""
    import torch

    from nwhead_tpu_torch.labs import LAB_KERNELS
    from nwhead_tpu_torch.ops import _cuda

    has_cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if has_cuda else 0
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": has_cuda,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "capability": (
            list(torch.cuda.get_device_capability(0)) if count else None
        ),
        "nvcc": _cuda.find_nvcc(),
        "kernels_built": {src.stem: _cuda.library_path(src.stem).exists()
                          for src in _cuda.sources()},
        "lab_kernels": dict(LAB_KERNELS),
    }


def __getattr__(name):
    """Lazy top-level exports (keep ``import nwhead_tpu_torch`` light)."""
    if name in ("NWNet", "NWModel"):
        from nwhead_tpu_torch.nw import net

        return getattr(net, name)
    if name == "NWHead":
        from nwhead_tpu_torch.nw.head import NWHead

        return NWHead
    if name == "load_model":
        from nwhead_tpu_torch.models import load_model

        return load_model
    if name in ("prepare_support", "nw_fused_from_prepared", "nw_fused_log_probs"):
        from nwhead_tpu_torch.ops import fused_nw

        return getattr(fused_nw, name)
    if name in ("parallel", "labs"):
        import importlib

        return importlib.import_module(f"nwhead_tpu_torch.{name}")
    if name in ("make_mesh", "ShardedSupportBank"):
        from nwhead_tpu_torch import parallel

        return getattr(parallel, name)
    raise AttributeError(name)


__all__ = [
    "capabilities",
    "get_kernel",
    "KERNEL_NAMES",
    "nw_log_probs",
    "prepare_support",
    "nw_fused_from_prepared",
    "nw_fused_log_probs",
    "NWNet",
    "NWModel",
    "NWHead",
    "load_model",
    "parallel",
    "labs",
    "make_mesh",
    "ShardedSupportBank",
    "__version__",
]
