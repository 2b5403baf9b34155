"""The IRM digits gate (ROADMAP.md queue 1, item 6): IRM training and the
per-environment ensemble on real images, through the port's API.

The protocol of ``scripts/irm_digits.py`` (which is not run here): each of
scikit-learn's digits training images goes to one of three seeded
environments, each with its own nuisance (identity, brightness
compression, gamma), and the validation set carries a shift no environment
has. ResNet-10 trains 8 epochs x 40 steps on single-environment episodes
(``train_type="irm"``), then evaluates full and ensemble mode. Gate: both
at least 97.3 acc with NLL at most 0.12. Both stacks recorded 98.63, NLL
0.046-0.072 (``BASELINE.md:371-374``); 97.3 stays above the 96.70-96.98
that mixed-environment training reached, against which the IRM advantage
is measured. Needs scikit-learn (the dataset): CPU only.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _env_shift(x: np.ndarray, env: int) -> np.ndarray:
    """The environments' nuisances on [0, 1] images (the protocol's own)."""
    if env == 0:
        return x
    if env == 1:
        return 0.8 * x + 0.2  # brightness-compressed
    if env == 2:
        return np.power(x, 1.5)  # gamma-darkened
    return 0.9 * x + 0.05  # the held-out validation shift


def test_irm_digits_gate():
    pytest.importorskip("sklearn")
    from nwhead_tpu_torch.data.datasets import ArrayDataset, make_digits_dataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.train.trainer import NWTrainer

    seed = 0
    tr, va = make_digits_dataset(train=True), make_digits_dataset(train=False)
    env_array = np.random.default_rng(seed).integers(0, 3, size=len(tr))
    imgs = np.stack([_env_shift(tr.images[i], int(env_array[i])) for i in range(len(tr))])
    train_ds = ArrayDataset(imgs.astype(np.float32), tr.targets, 10)
    val_ds = ArrayDataset(_env_shift(va.images, 99).astype(np.float32), va.targets, 10)

    featurizer = load_model("resnet10", device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    net = NWNet(featurizer, 10, support_dataset=train_ds, device="cpu", feat_dim=512,
                train_type="irm", env_array=env_array, n_shot=1, n_way=8, seed=seed)
    assert net.support_eval.envs.n_envs == 3
    trainer = NWTrainer(net, train_ds, val_ds, lr=1e-2, batch_size=8, milestones=(5, 7),
                        gamma=0.1, eval_modes=("full", "ensemble"), seed=seed)
    for _ in range(8):
        trainer.train_epoch(num_steps=40)
    trainer.eval_all_modes()
    assert [len(f) for f in net.support_eval.full_feat_sep] == [
        len(i) for i in net.support_eval.full_bank_indices]
    out = {mode: {name: trainer.val_metrics[f"{name}:val:{mode}"].result()
                  for name in ("acc", "loss", "ece")} for mode in ("full", "ensemble")}
    print("irm digits gate:", out)
    for mode, r in out.items():
        assert r["acc"] >= 97.3 and r["loss"] <= 0.12, (mode, out)
