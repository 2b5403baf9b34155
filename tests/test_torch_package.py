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
    "nwhead_tpu_torch.nw.head", "nwhead_tpu_torch.nw.net", "nwhead_tpu_torch.nw.support",
    "nwhead_tpu_torch.data.datasets", "nwhead_tpu_torch.serve",
)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import nwhead_tpu_torch as p\n"
        "p.NWNet, p.NWHead, p.load_model, p.prepare_support\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nwhead_tpu', 'sklearn', 'triton'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_capabilities_report_no_gpu_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    caps = nwhead_tpu_torch.capabilities()
    assert caps["torch"] == torch.__version__
    assert caps["cuda_available"] is False
    assert caps["device_count"] == 0 and caps["devices"] == []
    assert caps["capability"] is None
    assert caps["kernels_built"] in (True, False)
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
    """The library name carries a hash of the source and flags; without
    nvcc the build raises instead of falling back."""
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(_cuda, "SOURCE", src)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    first = _cuda.library_path()
    assert first.parent == tmp_path / "build" and first.name.startswith("libnw_prepared_")
    src.write_text("// b\n")
    assert _cuda.library_path() != first
    monkeypatch.setattr(_cuda, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()
