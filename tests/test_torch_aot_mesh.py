"""The mesh serving artifact (``export_mesh_serving_artifact``,
``load_mesh_serving_artifact``) held to ``tests/test_aot.py``'s mesh cases
on the CPU, the mesh (2, 4) over eight copies of the CPU device (JAX's over
the eight virtual devices of ``tests/conftest.py``).

JAX's ``Tiny`` featurizer (a 3x3 conv, BatchNorm, ReLU, the spatial mean, a
16-wide Dense) over ``make_synthetic_dataset(n=40, size=8)`` with its
weights carried into the port's copy of it (the quantized ViT's mesh case
is ``tests/test_torch_aot_mesh_vit.py``'s). The port's live mesh
callable (raw shards on the CPU) matches JAX's live sharded predict within
``JAX_TOL`` (2e-3 on probabilities, the same argmax); the reloaded program
(prepared shards of the live rows) matches the live callable at JAX's
1e-3 / 1e-4 with the same argmax, and a second load gives the same bits.
The guards: the single-device loader refuses a mesh artifact ("mesh") and
the mesh loader a single-device one ("single-device"); a mesh of another
shape "does not match", a mesh of other devices is refused by name (the
program fixes each shard's device). Shared helpers:
``tests/torch_aot_cases.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from torch_aot_cases import CPU8, mesh_held, mesh_live_matches_jax

torch.set_num_threads(1)


class Tiny(nn.Module):
    """The port's copy of JAX ``test_aot``'s ``Tiny``: NHWC in, a SAME 3x3
    conv to 8 channels, BatchNorm (eval: running statistics), ReLU, the
    spatial mean, a Dense to 16."""

    feat_dim = 16

    def __init__(self) -> None:
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8, eps=1e-5)
        self.dense = nn.Linear(8, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.dense(h.mean(dim=(2, 3)))

    def load_jax(self, variables) -> "Tiny":
        p, s = variables["params"]["featurizer"], variables["batch_stats"]["featurizer"]
        t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
        sd = {"conv.weight": t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1),
              "conv.bias": t(p["Conv_0"]["bias"]), "bn.weight": t(p["BatchNorm_0"]["scale"]),
              "bn.bias": t(p["BatchNorm_0"]["bias"]), "bn.running_mean": t(s["BatchNorm_0"]["mean"]),
              "bn.running_var": t(s["BatchNorm_0"]["var"]),
              "bn.num_batches_tracked": torch.tensor(0),
              "dense.weight": t(p["Dense_0"]["kernel"]).T, "dense.bias": t(p["Dense_0"]["bias"])}
        self.load_state_dict(sd)
        return self


@pytest.fixture(scope="module")
def mesh_pair():
    """JAX ``test_aot``'s ``mesh_net`` and the port's on the same weights,
    both precomputed over a (2, 4) mesh: ``(jnet, variables, tnet, x)``."""
    import flax.linen as fnn

    from nwhead_tpu.data import make_synthetic_dataset as jsynthetic
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.parallel.mesh import make_mesh as jmake_mesh
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.parallel.mesh import make_mesh

    class JTiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = True):
            x = fnn.Conv(8, (3, 3), padding="SAME")(x)
            x = fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
            x = fnn.relu(x)
            x = jnp.mean(x, axis=(1, 2))
            return fnn.Dense(16)(x)

    common = dict(feat_dim=16, n_shot=1, n_shot_full=5, fused_min_support=1, seed=0)
    ds = jsynthetic(n=40, n_classes=4, size=8, seed=0)
    jnet = JNWNet(JTiny(), n_classes=4, support_dataset=ds, mesh=jmake_mesh(2, 4), **common)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(ds.gather(np.arange(2))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(5)  # BN statistics off (0, 1): a non-trivial eval pass
    stats = variables["batch_stats"]["featurizer"]["BatchNorm_0"]
    stats["mean"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    jnet.precompute(variables)
    tnet = NWNet(Tiny().load_jax(variables), 4, device="cpu", mesh=make_mesh(2, 4, devices=CPU8),
                 support_dataset=make_synthetic_dataset(n=40, n_classes=4, size=8, seed=0),
                 **common)
    tnet.precompute()
    return jnet, variables, tnet, ds.gather(np.arange(8))


def test_mesh_export_reload_parity(mesh_pair, tmp_path):
    """One program over the mesh: each shard's partials op on its device,
    the exact merge; it reproduces the live sharded predict and reloads to
    the same bits; the single-device loader refuses it."""
    from nwhead_tpu_torch.utils.aot import (
        export_mesh_serving_artifact, load_mesh_serving_artifact, load_serving_artifact,
    )

    jnet, variables, tnet, x = mesh_pair
    live = mesh_live_matches_jax(jnet, variables, tnet, x)
    art = str(tmp_path / "mesh_art")
    meta = export_mesh_serving_artifact(tnet, x, art)
    assert meta["nr_devices"] == 8 and meta["mesh_shape"] == [2, 4, 1]
    assert meta["mesh_axis_names"][:2] == ["data", "support"]
    fn = load_mesh_serving_artifact(art)
    got = fn(x).numpy()
    mesh_held(got, live)
    assert fn.mesh.shape == tnet.mesh.shape
    np.testing.assert_array_equal(load_mesh_serving_artifact(art)(x).numpy(), got)
    program = torch.export.load(f"{art}/program.pt2")
    ops = [str(n.target) for n in program.graph.nodes if "nwhead_torch" in str(n.target)]
    assert ops == ["nwhead_torch.nw_prepared_partials.default"] * 8  # 2 data rows x 4 shards
    with pytest.raises(ValueError, match="mesh"):
        load_serving_artifact(art)


def test_mesh_artifact_guards(mesh_pair, tmp_path):
    """A mesh of another shape does not match; a mesh of other devices is
    refused by name; the mesh loader refuses a single-device artifact."""
    from nwhead_tpu_torch.parallel.mesh import make_mesh
    from nwhead_tpu_torch.utils.aot import (
        export_mesh_serving_artifact, export_serving_artifact, load_mesh_serving_artifact,
    )

    _, _, tnet, x = mesh_pair
    art = str(tmp_path / "m")
    export_mesh_serving_artifact(tnet, x, art)
    with pytest.raises(ValueError, match="does not match"):
        load_mesh_serving_artifact(art, mesh=make_mesh(4, 2, devices=CPU8))
    with pytest.raises(ValueError, match="are not the artifact's"):
        load_mesh_serving_artifact(art, mesh=make_mesh(2, 4, devices=[torch.device("cpu", 0)] * 8))
    same = load_mesh_serving_artifact(art, mesh=make_mesh(2, 4, devices=CPU8))
    assert same(x).shape == (8, 4)

    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.nw.net import NWNet

    single = NWNet(tnet.model.featurizer, 4, device="cpu", feat_dim=16, n_shot_full=5,
                   fused_min_support=1,
                   support_dataset=make_synthetic_dataset(n=40, n_classes=4, size=8, seed=0))
    single.precompute()
    sart = str(tmp_path / "s")
    export_serving_artifact(single.make_serving_fn(), x[:4], sart)
    with pytest.raises(ValueError, match="single-device"):
        load_mesh_serving_artifact(sart)
    # The live mesh callable reads the bank per call: it has no export hook.
    with pytest.raises(ValueError, match="export_mesh_serving_artifact"):
        export_serving_artifact(tnet.make_serving_fn(), x, str(tmp_path / "bad"))
