"""The ViT training slice against the JAX package, on the CPU.

* Two ``NWTrainer`` steps of a narrow ViT (patch 16, D=64, 2 blocks, 2
  heads, 32 px images, LayerScale gammas of order 1) with the fused impls
  in both packages (JAX runs its Pallas kernels, forward and custom VJPs,
  in interpret mode; the port runs the plain versions of K7, K8 and the K9
  forward and backward through its autograd Functions), from the same
  weights carried across with ``jax_to_torch_nwmodel``, on the same episode
  stream: mean loss at rtol 1e-4; every parameter within 1% of how far the
  JAX step moved it (as ``tests/test_torch_train_slice.py`` holds the
  ResNet).
* The training CLI trains ``--arch vit_s16 --device cpu`` for 2 steps, in
  f32 and with ``--bf16``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.models import vit as tvit
from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import fused_attn, fused_mlp
from nwhead_tpu_torch.train import main as train_main
from nwhead_tpu_torch.train.trainer import NWTrainer

torch.set_num_threads(1)

SMALL = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, img_size=32,
             attn_impl="fused", mlp_impl="fused")
STEP_REL = 1e-2  # of the JAX update's size, per tensor
# Absolute floor of a parameter's difference after the steps: the final
# LayerNorm's bias shifts query and support features alike, so under the
# euclidean head its gradient is 0 up to rounding, and both packages move
# it by rounding noise alone (1.7e-8 in JAX, 4.7e-7 here).
STEP_FLOOR = 1e-6


class _JaxVitNet:
    """The JAX ``NWNet`` of a ViT, with an empty ``batch_stats`` collection
    in its variables: the JAX ``NWTrainer`` reads ``variables
    ["batch_stats"]``, which a BatchNorm-free featurizer does not have
    (ROADMAP.md queue 3)."""

    def __init__(self, net):
        self._net = net

    def __getattr__(self, name):
        return getattr(self._net, name)

    def init(self, *args, **kwargs):
        return {"batch_stats": {}, **self._net.init(*args, **kwargs)}


def _trainers():
    """A JAX and a port trainer on the same data, episodes and weights."""
    from nwhead_tpu.data.datasets import make_synthetic_dataset as jsyn
    from nwhead_tpu.models import vit as jvit
    from nwhead_tpu.nw.net import NWNet as JNWNet
    from nwhead_tpu.train import NWTrainer as JNWTrainer

    common = dict(feat_dim=64, n_shot=4, seed=0)
    tkw = dict(lr=0.05, batch_size=4, milestones=(100,), weight_decay=1e-4,
               eval_modes=("random", "full"), seed=0)
    jtrain, jval = jsyn(n=48, n_classes=4, size=32, seed=0), jsyn(n=16, n_classes=4, size=32, seed=1)
    jnet = _JaxVitNet(JNWNet(jvit.VisionTransformer(**SMALL), 4, support_dataset=jtrain, **common))
    jtr = JNWTrainer(jnet, jtrain, jval, **tkw)
    params = jax.tree_util.tree_map(jnp.asarray, jtr.state.params)
    rng = np.random.default_rng(7)
    for i in range(SMALL["depth"]):
        for g in ("ls1_gamma", "ls2_gamma"):
            params["featurizer"][f"block{i}"][g] = jnp.asarray(
                rng.uniform(0.5, 1.5, SMALL["embed_dim"]).astype(np.float32))
    jtr.state.params = params  # momentum starts at 0, whatever the weights

    ttrain = tdata.make_synthetic_dataset(n=48, n_classes=4, size=32, seed=0)
    tval = tdata.make_synthetic_dataset(n=16, n_classes=4, size=32, seed=1)
    tnet = NWNet(tvit.VisionTransformer(**SMALL), 4, support_dataset=ttrain, device="cpu",
                 **common)
    tnet.model.load_state_dict(_torch_state(jtr))
    return jtr, NWTrainer(tnet, ttrain, tval, **tkw)


def _torch_state(jtr):
    return jax_to_torch_nwmodel(jax.tree_util.tree_map(
        np.asarray, {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))


def test_two_vit_trainer_steps_match_jax():
    jtr, ttr = _trainers()
    before = {k: v.clone() for k, v in ttr.net.model.state_dict().items()}
    launches = (fused_attn.attention_qkv_bwd_cuda.launches, fused_mlp.mlp_bwd_cuda.launches)
    ttr.train_epoch(num_steps=2)
    jtr.train_epoch(num_steps=2)
    assert ttr.step == jtr.state.step == 2
    # CPU tensors: the plain versions ran, no kernel.
    assert (fused_attn.attention_qkv_bwd_cuda.launches, fused_mlp.mlp_bwd_cuda.launches) == launches
    np.testing.assert_allclose(ttr.metrics["loss:train"].result(),
                               jtr.metrics["loss:train"].result(), rtol=1e-4)
    want = _torch_state(jtr)
    got = ttr.net.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        moved = float((v - before[k]).abs().max())
        err = float((got[k] - v).abs().max())
        assert err <= STEP_REL * moved + STEP_FLOOR, (k, err, moved)
    for name in ("featurizer.blocks.0.attn.qkv.weight", "featurizer.blocks.1.mlp.fc1.weight",
                 "featurizer.blocks.1.ls2_gamma", "featurizer.patch_embed.weight"):
        assert not torch.equal(got[name], before[name]), name


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cli_trains_vit_s16_on_cpu(tmp_path, bf16):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--arch", "vit_s16", "--batch_size",
            "4", "--n_way", "4", "--num_epochs", "1", "--num_steps_per_epoch", "2",
            "--num_val_steps_per_epoch", "1", "--models_dir", str(tmp_path)]
    trainer = train_main(argv + (["--bf16"] if bf16 else []))
    assert trainer.step == 2 and len(trainer.step_losses) == 2
    assert np.isfinite(trainer.step_losses).all()
    vit = trainer.net.model.featurizer
    assert isinstance(vit, tvit.VisionTransformer)
    assert vit.dtype == (torch.bfloat16 if bf16 else None)
    assert vit.blocks[0].attn.attn_impl == "xla"  # the JAX CLI's default impls
    assert all(p.dtype == torch.float32 for p in vit.parameters())
