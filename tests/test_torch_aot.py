"""The AOT serving artifact of the port (``nwhead_tpu_torch/utils/aot.py``,
``ops/library.py``, the serve CLI's ``--export_artifact`` /
``--serve_artifact``) held to ``tests/test_aot.py``'s single-device cases,
on the CPU, where the custom ops run the kernels' plain versions.

Every case exports a live serving callable, reloads it and holds the
reloaded program to the live callable at JAX's tolerance (``ART_TOL``:
rtol = atol = 1e-6 on the log-probs), and holds the live callable to JAX's
live serving fn on the same weights (carried by ``jax_to_torch_nwmodel``,
the int8 featurizers by ``jax_to_torch_quantized_*``) at the tolerance of
the port's serving parity tests (``JAX_TOL``: 2e-3 on probabilities, the
same argmax; ``tests/test_torch_serve_slice.py``,
``tests/test_torch_quant_vit.py``). The fixtures are JAX's: resnet10 at 32
px over 48 rows (4 classes, 12 a class), the int8 resnet10 over 24 rows.
The cases: float, int4 bank, uint8 normalize, plain callables refused,
another device refused, int8 CNN, ``ivf`` at a full and a pruned probe;
beside them the ops' fake and meta behaviour and a fresh
interpreter that loads an artifact with no model-building module, no JAX.
The quantized ViT is ``tests/test_torch_aot_vit.py``'s case, the CLI both
ways ``tests/test_torch_aot_cli.py``'s, the mesh cases
``tests/test_torch_aot_mesh.py``'s (shared helpers:
``tests/torch_aot_cases.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_aot_cases import (
    ART_TOL, IMAGENET, REPO, rows, live_matches_jax, net_pair, roundtrip,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    """JAX ``test_aot``'s ``small_net``: resnet10, 32 px, 48 rows, 4 classes."""
    x, y = rows(0, 4, 48, 32)
    return (*net_pair("resnet10", x, y, 4, 12), x)


def test_export_reload_parity_float(small, tmp_path):
    jnet, variables, tnet, x = small
    fn = tnet.make_serving_fn()
    live_matches_jax(fn, jnet.make_serving_fn(variables), x[:6])
    meta = roundtrip(fn, x[:6], str(tmp_path / "art"))
    assert meta["n_operand_leaves"] > 0
    assert meta["input_shape"] == [6, 32, 32, 3] and meta["input_dtype"] == "float32"
    assert (meta["device"], meta["capability"]) == ("cpu", None)
    program = torch.export.load(str(tmp_path / "art" / "program.pt2"))
    ops = {str(n.target) for n in program.graph.nodes if "nwhead_torch" in str(n.target)}
    assert ops == {"nwhead_torch.nw_prepared.default"}


def test_export_reload_parity_int4_bank(tmp_path):
    """An int4 bank (uint8, two codes a byte) rides as a stored tensor; the
    program calls the K5 op."""
    x, y = rows(3, 4, 48, 32)
    jnet, variables, tnet = net_pair("resnet10", x, y, 4, 12, head_precision="int4")
    assert tnet._prepared_full.s.dtype == torch.uint8
    fn = tnet.make_serving_fn()
    live_matches_jax(fn, jnet.make_serving_fn(variables), x[:6])
    roundtrip(fn, x[:6], str(tmp_path / "art4"))
    program = torch.export.load(str(tmp_path / "art4" / "program.pt2"))
    assert "nwhead_torch.nw_prepared_int4.default" in {str(n.target) for n in program.graph.nodes}


def test_export_reload_parity_uint8_normalize(small, tmp_path):
    """The deployment form: uint8 pixels in, the normalization folded in."""
    jnet, variables, tnet, _ = small
    fn = tnet.make_serving_fn(normalize=IMAGENET)
    q = np.random.default_rng(1).integers(0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    live_matches_jax(fn, jnet.make_serving_fn(variables, normalize=IMAGENET), q)
    meta = roundtrip(fn, q, str(tmp_path / "art8"))
    assert meta["input_dtype"] == "uint8"


def test_export_rejects_plain_callables(small, tmp_path):
    from types import SimpleNamespace

    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.utils.aot import export_serving_artifact

    with pytest.raises(ValueError, match="make_serving_fn"):
        export_serving_artifact(lambda x: x, np.ones((2, 2)), str(tmp_path / "bad"))
    # The relation kernel has no fused route: the CLI's export names it.
    with pytest.raises(ValueError, match="'relation' kernel has no fused"):
        pserve.export_artifact(SimpleNamespace(kernel_type="relation"), None, None, None)


def test_device_mismatch_refuses(small, tmp_path):
    """An artifact exported for another device (here: rewritten as a card's)
    is refused, as by JAX's "lowered for" guard."""
    from nwhead_tpu_torch.utils.aot import (
        export_serving_artifact, load_any_serving_artifact, load_serving_artifact,
    )

    _, _, tnet, x = small
    art = tmp_path / "artp"
    export_serving_artifact(tnet.make_serving_fn(), x[:2], str(art))
    meta = json.loads((art / "meta.json").read_text())
    meta.update(device="cuda", capability="sm_90a")
    (art / "meta.json").write_text(json.dumps(meta))
    for load in (load_serving_artifact, load_any_serving_artifact):
        with pytest.raises(ValueError, match="exported for another device"):
            load(str(art))


def test_export_reload_parity_int8_featurizer(tmp_path):
    """The int8 CNN (BN-folded resnet10 on the exact int32 conv route, as
    ordinary aten ops): its int8 weights stored tensors, the head K2's op."""
    x, y = rows(3, 3, 24, 32)
    jnet, variables, tnet = net_pair("resnet10", x, y, 3, 6, quantize=8)
    fn = tnet.make_serving_fn()
    live_matches_jax(fn, jnet.make_serving_fn(variables), x[:4])
    roundtrip(fn, x[:4], str(tmp_path / "arti8"))


def test_export_reload_parity_ivf_mode(small, tmp_path):
    """``make_serving_fn(mode="ivf")`` exports with its probe fixed: the IVF
    bank and its routing index are stored tensors and the routed program
    (static shapes, K6's op) reproduces the live callable, at a full probe
    (which equals full mode) and at a pruned one, each its own artifact."""
    jnet, variables, tnet, x = small
    q = x[:6]
    for probe, art in ((10_000, "art_ivf"), (2, "art_ivf2")):
        jnet.ivf_n_probe = tnet.ivf_n_probe = probe
        jnet._ivf_cache = tnet._ivf_cache = None
        fn = tnet.make_serving_fn(mode="ivf")
        live = live_matches_jax(fn, jnet.make_serving_fn(variables, mode="ivf"), q)
        if probe > 1_000:
            full = tnet.make_serving_fn()(q).numpy()
            np.testing.assert_allclose(np.exp(live), np.exp(full), rtol=1e-5, atol=1e-6)
        roundtrip(fn, q, str(tmp_path / art))
        program = torch.export.load(str(tmp_path / art / "program.pt2"))
        assert "nwhead_torch.nw_prepared_sel.default" in {
            str(n.target) for n in program.graph.nodes}
    tnet.ivf_n_probe = "auto"
    tnet._ivf_cache = None
    with pytest.raises(ValueError, match="unresolved"):
        tnet.serving_module(mode="ivf")


def test_ops_fake_shapes_and_meta_refused():
    """The custom ops: under ``FakeTensorMode`` each gives its output's shape
    and dtype from its fake implementation (no library, no card); a ``meta``
    tensor reaches the fake implementation, which refuses it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from nwhead_tpu_torch.ops import library as L

    B, S, D, C = 5, 40, 16, 7
    with FakeTensorMode():
        q, s = torch.empty(B, D), torch.empty(S, D)
        s2, labels, scale = torch.empty(S), torch.empty(S, dtype=torch.int32), torch.empty(1)
        out = L.nw_prepared(q, s, s2, labels, None, scale, None, "l2", C)
        assert out.shape == (B, C) and out.dtype == torch.float32
        m, l, acc = L.nw_prepared_partials_int8(q.to(torch.int8), s.to(torch.int8), s2, labels,
                                                torch.empty(S), scale, torch.empty(B), "l2", C)
        assert (m.shape, l.shape, acc.shape) == ((B, 1), (B, 1), (B, C))
        sel = L.nw_prepared_sel(q, s, s2, labels, None, scale, None,
                                torch.empty(2, dtype=torch.int32), 128, "dot", C)
        assert sel.shape == (B, C)
        qkv = torch.empty(2, 9, 3 * 64, dtype=torch.bfloat16)
        att = L.attention_qkv(qkv, 2, 0.125)
        assert att.shape == (2, 9, 64) and att.dtype == torch.bfloat16
        x = torch.empty(18, 64, dtype=torch.bfloat16)
        w1, w2 = torch.empty(64, 256, dtype=torch.int8), torch.empty(256, 32, dtype=torch.int8)
        blk = L.mlp_block_int8(x, w1, torch.empty(256), torch.empty(256), 0.1, w2,
                               torch.empty(32), torch.empty(32), 0.2, None, None, 1e-6, None,
                               False)
        assert blk.shape == (18, 32) and blk.dtype == torch.bfloat16
    meta = torch.empty(B, D, device="meta")
    with pytest.raises(ValueError, match="not on meta"):
        L.nw_prepared(meta, meta.new_empty(S, D), None, meta.new_empty(S, dtype=torch.int32),
                      None, meta.new_empty(1), None, "dot", C)
    with pytest.raises(ValueError, match="not on meta"):
        L.attention_qkv(meta.new_empty(2, 9, 192), 2, 0.125)


def test_fresh_interpreter_loads_without_model_code(small, tmp_path):
    """A new interpreter loads an artifact with ``utils.aot`` alone and
    answers a batch equal to the live callable's; neither JAX nor the
    port's model-building modules are imported."""
    from nwhead_tpu_torch.utils.aot import export_serving_artifact

    _, _, tnet, x = small
    fn = tnet.make_serving_fn()
    art = str(tmp_path / "fresh")
    export_serving_artifact(fn, x[:4], art)
    np.save(tmp_path / "q.npy", x[:4])
    np.save(tmp_path / "want.npy", fn(x[:4]).numpy())
    code = f"""
import json, sys
import numpy as np
from nwhead_tpu_torch.utils.aot import load_any_serving_artifact
fn = load_any_serving_artifact({art!r})
got = fn(np.load({str(tmp_path / 'q.npy')!r})).numpy()
want = np.load({str(tmp_path / 'want.npy')!r})
print(json.dumps({{"err": float(np.abs(got - want).max()),
                  "modules": [m for m in ("jax", "nwhead_tpu", "nwhead_tpu_torch.nw.net",
                                          "nwhead_tpu_torch.models") if m in sys.modules]}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env={
        **env, "PYTHONPATH": REPO}, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["modules"] == [] and rep["err"] <= ART_TOL
