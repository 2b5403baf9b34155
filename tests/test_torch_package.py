"""The port's package surface: it imports no jax, reports only the devices
it has, and never turns a CUDA request into a CPU run."""

import json
import os
import subprocess
import sys

import pytest
import torch

import nwhead_tpu_torch
from nwhead_tpu_torch.ops import _cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = (
    "nwhead_tpu_torch", "nwhead_tpu_torch.ops.kernels", "nwhead_tpu_torch.ops.nw",
    "nwhead_tpu_torch.ops.fused_nw", "nwhead_tpu_torch.ops._cuda",
    "nwhead_tpu_torch.models", "nwhead_tpu_torch.models.convert",
    "nwhead_tpu_torch.models.resnet", "nwhead_tpu_torch.models.densenet",
    "nwhead_tpu_torch.models.pretrained",
    "nwhead_tpu_torch.nw.head", "nwhead_tpu_torch.nw.net", "nwhead_tpu_torch.nw.support",
    "nwhead_tpu_torch.data.datasets", "nwhead_tpu_torch.serve",
    "nwhead_tpu_torch.ops.metrics", "nwhead_tpu_torch.data.pipeline",
    "nwhead_tpu_torch.train", "nwhead_tpu_torch.train.trainer",
    "nwhead_tpu_torch.train.config", "nwhead_tpu_torch.train.checkpoint",
    "nwhead_tpu_torch.ops.fused_attn", "nwhead_tpu_torch.ops.fused_mlp",
    "nwhead_tpu_torch.models.vit", "nwhead_tpu_torch.models.serving_vit",
    "nwhead_tpu_torch.parallel", "nwhead_tpu_torch.parallel.mesh",
    "nwhead_tpu_torch.parallel.sharded_bank", "nwhead_tpu_torch.nw.streaming",
    "nwhead_tpu_torch.ops.knn", "nwhead_tpu_torch.native.hnsw",
    "nwhead_tpu_torch.labs", "nwhead_tpu_torch.labs.timing", "nwhead_tpu_torch.labs.stream",
    "nwhead_tpu_torch.labs.kernel_lab", "nwhead_tpu_torch.labs.manual_pipe_lab",
    "nwhead_tpu_torch.labs.prepared_lab", "nwhead_tpu_torch.labs.roofline_lab",
    "nwhead_tpu_torch.labs.block_lab", "nwhead_tpu_torch.models.quantize",
    "nwhead_tpu_torch.ops.int8_conv",
)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import nwhead_tpu_torch as p\n"
        "p.NWNet, p.NWHead, p.load_model, p.prepare_support, p.nw_fused_log_probs\n"
        "p.parallel, p.make_mesh, p.ShardedSupportBank, p.labs\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nwhead_tpu', 'sklearn', 'triton',"
        " 'scripts', 'bench', 'timing'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_package_import_stays_light():
    """The top-level exports load on first use: importing the package pulls
    in neither the sharded-serving modules nor the model code."""
    code = (
        "import json, sys\n"
        "import nwhead_tpu_torch as p\n"
        "before = sorted(m for m in sys.modules if m.startswith(('nwhead_tpu_torch.parallel',"
        " 'nwhead_tpu_torch.nw', 'nwhead_tpu_torch.models', 'nwhead_tpu_torch.labs')))\n"
        "mesh = p.make_mesh(1, 2, devices=['cpu', 'cpu'])\n"
        "print(json.dumps([before, mesh.shape, 'nwhead_tpu_torch.parallel' in sys.modules]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    before, shape, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert before == [] and loaded
    assert shape == {"data": 1, "support": 2, "model": 1}


def test_capabilities_report_no_gpu_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    caps = nwhead_tpu_torch.capabilities()
    assert caps["torch"] == torch.__version__
    assert caps["cuda_available"] is False
    assert caps["device_count"] == 0 and caps["devices"] == []
    assert caps["capability"] is None
    assert set(caps["kernels_built"]) == {"nw_fused", "nw_prepared", "vit_attn", "vit_attn_bwd",
                                          "vit_mlp", "vit_mlp_bwd", "lab_stream", "lab_nw",
                                          "lab_blocks"}
    assert caps["lab_kernels"] == {"stream": "lab_stream", "stream_reduce": "lab_stream",
                                   "fused_variant": "lab_nw", "manual_fused": "lab_nw",
                                   "fused_blocks": "lab_blocks"}
    assert all(v in (True, False) for v in caps["kernels_built"].values())
    assert json.dumps(caps)  # plain data, printable as JSON


def test_cuda_request_without_a_gpu_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        NWNet(load_model("resnet10", device="cpu"), 4, device="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.serve", "--dataset", "synthetic",
         "--arch", "resnet10", "--latency_bench"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """One library per ``.cu`` source, named by a hash of every source and
    header in ``csrc/`` and the flags, so editing a shared header rebuilds
    them all; without nvcc the build raises instead of falling back."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a\n")
    (csrc / "k2.cu").write_text("// c\n")
    (csrc / "common.cuh").write_text("// h\n")
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    assert [p.name for p in _cuda.sources()] == ["k.cu", "k2.cu"]
    first = _cuda.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("libk_")
    (csrc / "k.cu").write_text("// b\n")
    second = _cuda.library_path("k")
    assert second != first
    (csrc / "common.cuh").write_text("// h2\n")
    assert _cuda.library_path("k") != second
    monkeypatch.setattr(_cuda, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()
