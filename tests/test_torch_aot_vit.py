"""The AOT artifact of the int8 ViT stack (``tests/test_aot.py``'s
quantized-ViT case): JAX's vit_s16 at 64 px over 12 rows, 3 classes, its
LayerScale gammas of order 1, its int8 PTQ calibrated on 6 images and
carried into the port
(``jax_to_torch_nwmodel``, ``jax_to_torch_quantized_vit``). The reloaded
program equals the port's live callable within ``ART_TOL`` (1e-6), which
matches JAX's live serving fn within ``JAX_TOL`` (2e-3 on probabilities,
the same argmax; ``tests/test_torch_quant_vit.py``'s slice tolerance).
Shared helpers: ``tests/torch_aot_cases.py``."""

import pytest
import torch

from torch_aot_cases import rows, live_matches_jax, net_pair, roundtrip

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def qvit():
    """JAX ``test_aot``'s quantized ViT: vit_s16 at 64 px, 12 rows, 3
    classes, int8 PTQ on 6 images, carried into the port."""
    x, y = rows(4, 3, 12, 64)
    return (*net_pair("vit_s16", x, y, 3, 4, quantize=6), x)


def test_export_reload_parity_quantized_vit(qvit, tmp_path):
    """The int8 ViT stack (K10 int8 and K11 int8 a block, K2): its weights
    are stored tensors (far more than the CNN's), never graph constants."""
    jnet, variables, tnet, x = qvit
    fn = tnet.make_serving_fn()
    live_matches_jax(fn, jnet.make_serving_fn(variables), x[:2])
    meta = roundtrip(fn, x[:2], str(tmp_path / "artvit"))
    assert meta["n_operand_leaves"] > 50
    program = torch.export.load(str(tmp_path / "artvit" / "program.pt2"))
    ops = [str(n.target) for n in program.graph.nodes if "nwhead_torch" in str(n.target)]
    assert ops.count("nwhead_torch.attention_block_int8.default") == 12
    assert ops.count("nwhead_torch.mlp_block_int8.default") == 12
    assert not program.constants or all(t.numel() <= 1 for t in program.constants.values())
