"""The quantized-ViT mesh artifact (``tests/test_aot.py``'s
``test_mesh_export_quantized_vit``) on the CPU: JAX's vit_s16 at 64 px over
24 rows (3 classes), its LayerScale gammas of order 1, int8 PTQ on 6
images, over a (2, 4) mesh (JAX's eight virtual CPU devices; the port's
``[cpu] * 8``), carried into the port (``jax_to_torch_nwmodel``,
``jax_to_torch_quantized_vit``). The port's live mesh callable matches
JAX's live sharded predict within ``JAX_TOL`` (2e-3 on probabilities, the
same argmax); the reloaded program matches the live callable at JAX's
1e-3 / 1e-4 with the same argmax; its stored tensors are the int8 tree and
the bank shards, no dead float tree. Shared helpers:
``tests/torch_aot_cases.py``."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_aot_cases import CPU8, mesh_held, mesh_live_matches_jax, order_one_gammas, rows

torch.set_num_threads(1)


def test_mesh_export_quantized_vit(tmp_path):
    """The quantized-ViT mesh export: the int8 tree and the bank shards are
    the stored tensors, with no dead float tree (stored bytes under twice
    the float weights'); the reloaded program matches the live sharded
    predict, which matches JAX's."""
    from nwhead_tpu.data import ArrayDataset as JArrayDataset
    from nwhead_tpu.models import load_model as jload
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.parallel.mesh import make_mesh as jmake_mesh
    from nwhead_tpu_torch.data.datasets import ArrayDataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel, jax_to_torch_quantized_vit
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.parallel.mesh import make_mesh
    from nwhead_tpu_torch.utils.aot import (
        export_mesh_serving_artifact, load_mesh_serving_artifact,
    )

    x, y = rows(9, 3, 24, 64)
    jvit = jload("vit_s16")
    common = dict(feat_dim=jvit.feat_dim, n_shot_full=8, fused_min_support=1, seed=0)
    jnet = JNWNet(jvit, 3, support_dataset=JArrayDataset(x, y, num_classes=3),
                  mesh=jmake_mesh(2, 4), **common)
    variables = order_one_gammas(jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))))
    jnet.quantize_featurizer(variables, x[:6])
    jnet.precompute(variables)
    tnet = NWNet(load_model("vit_s16", device="cpu"), 3, device="cpu",
                 support_dataset=ArrayDataset(x, y, num_classes=3),
                 mesh=make_mesh(2, 4, devices=CPU8), **common)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(variables))
    tnet.serving_featurizer = jax_to_torch_quantized_vit(jnet.quantized_featurizer)
    tnet._record_source()
    tnet.precompute()

    q = x[:8]
    live = mesh_live_matches_jax(jnet, variables, tnet, q)
    art = str(tmp_path / "mesh_vit")
    meta = export_mesh_serving_artifact(tnet, q, art)
    assert meta["nr_devices"] == 8 and meta["n_operand_leaves"] > 50
    program = torch.export.load(f"{art}/program.pt2")
    stored = sum(t.numel() * t.element_size()
                 for t in [*program.state_dict.values(), *program.constants.values()])
    float_tree = sum(p.numel() * p.element_size() for p in tnet.model.featurizer.parameters())
    assert stored < 2 * float_tree and stored < float_tree  # the int8 tree and the bank only
    got = load_mesh_serving_artifact(art)(q).numpy()
    mesh_held(got, live)
