"""The episodic NW training and evaluation loop.

Port of ``NWTrainer`` from ``nwhead_tpu/train/trainer.py``:

* SGD with momentum 0.9, nesterov, and L2 weight decay added to the
  gradient (``torch.optim.SGD``, the update ``optax.chain(
  add_decayed_weights, sgd(nesterov=True))`` makes);
* the milestone schedule ``lr * gamma ** (milestones passed)``, milestones
  in epochs, set before every step from the step count, so it crosses a
  milestone at the same step as optax's ``piecewise_constant_schedule``;
* NLL loss on the log-probs, each step one featurizer batch of query and
  support (``NWModel.forward``);
* an in-memory, transform-free training set lives on the device and a step
  ships only indices; other datasets go through pinned-buffer prefetch;
* loss and accuracy stay on the device and are read once per epoch;
* eval per mode (random, full and cluster by default) over the validation
  set, its tail batch padded (row 0 on the device path, zero images on the
  host path, as in the JAX package), ECE over the epoch's concatenated
  probabilities x100; ``eval_all_modes`` returns full-mode accuracy, the
  best-checkpoint key.

``freeze_featurizer`` takes the featurizer's parameters out of the
optimizer and out of autograd: they get no update at all, weight decay
included (the JAX package's optimizer still decays them, ROADMAP.md queue
3). BatchNorm running statistics update in train mode either way, as in
the JAX package.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from nwhead_tpu_torch.data.pipeline import EpisodicBatcher, device_images, prefetch_to_device
from nwhead_tpu_torch.nw.net import NWNet
from nwhead_tpu_torch.ops import metrics as M


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int):
    """``step -> lr``: torch's ``MultiStepLR`` on epoch milestones, per step
    (``gamma`` applies from step ``milestone * steps_per_epoch`` on)."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


def _eval_indices(n: int, batch_size: int, num_steps: Optional[int]):
    """Sequential eval batches of ``batch_size`` rows, the tail padded with
    row 0 (padding rows are dropped from every metric): ``(padded indices,
    indices of the real rows)``. The device path's batches, as the JAX
    package pads its device-resident eval set."""
    for count, start in enumerate(range(0, n, batch_size)):
        if num_steps is not None and count >= num_steps:
            return
        idx = np.arange(start, min(start + batch_size, n))
        padded = np.zeros(batch_size, np.int64)
        padded[:len(idx)] = idx
        yield padded, idx


def _host_eval_batches(ds, batch_size: int, num_steps: Optional[int]):
    """The host path's eval batches: ``(images (batch_size, H, W, C) f32,
    labels of the real rows)``, the tail padded with zero images, as the
    JAX package's ``_padded_eval_batches`` pads it (in knn and hnsw mode a
    padding row's neighbours join the batch's support, so the padding is
    part of the result)."""
    for _, idx in _eval_indices(len(ds), batch_size, num_steps):
        img = np.asarray(ds.gather(idx), np.float32)
        if len(idx) < batch_size:
            img = np.concatenate([img, np.zeros((batch_size - len(idx), *img.shape[1:]),
                                                np.float32)])
        yield img, np.asarray(ds.targets[idx])


class NWTrainer:
    """Episodic NW training and multi-mode evaluation of an ``NWNet``."""

    def __init__(
        self,
        net: NWNet,
        train_dataset,
        val_dataset,
        lr: float = 1e-3,
        batch_size: int = 1,
        milestones: Sequence[int] = (100, 150),
        gamma: float = 0.1,
        weight_decay: float = 1e-4,
        freeze_featurizer: bool = False,
        eval_modes: Sequence[str] = ("random", "full", "cluster"),
        seed: int = 0,
    ) -> None:
        self.net = net
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.batch_size = batch_size
        self.eval_modes = tuple(eval_modes)
        self.rng = np.random.default_rng(seed)
        self.steps_per_epoch = max(1, len(train_dataset) // batch_size)
        self.step = 0
        self.lr_schedule = multistep_lr(lr, milestones, gamma, self.steps_per_epoch)
        if freeze_featurizer:
            net.model.featurizer.requires_grad_(False)
        params = [p for p in net.model.parameters() if p.requires_grad]
        self.optimizer = (
            torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True,
                            weight_decay=weight_decay)
            if params else None
        )
        self.metrics = {k: M.Metric() for k in ("loss:train", "acc:train")}
        self.val_metrics = {
            f"{name}:val:{mode}": M.Metric()
            for mode in self.eval_modes for name in ("loss", "acc", "ece")
        }
        self.train_seconds = 0.0  # host time of the last train_epoch, synchronized
        self.step_losses: List[float] = []  # per-step losses of the last train_epoch

    # -- state -------------------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "model": self.net.model.state_dict(),
            "optimizer": None if self.optimizer is None else self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.net.model.load_state_dict(state["model"])
        if self.optimizer is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    # -- training ----------------------------------------------------------------

    def train_step(self, qimg: torch.Tensor, qy: torch.Tensor, simg: torch.Tensor,
                   sy: torch.Tensor):
        """One SGD step on one episode, all on the device: returns the
        detached loss and accuracy (no host read)."""
        model = self.net.model
        model.train()
        log_probs = model(qimg, simg, sy)
        loss = M.nll_loss(log_probs, qy)
        if self.optimizer is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.step)
            self.optimizer.zero_grad(set_to_none=True)
            if loss.requires_grad:
                loss.backward()
            self.optimizer.step()
        self.step += 1
        acc = torch.mean((torch.argmax(log_probs.detach(), -1) == qy).to(torch.float32))
        return loss.detach(), acc

    def train_epoch(self, num_steps: Optional[int] = None, prefetch: int = 2) -> None:
        """One epoch of episodes. The batcher is seeded from the trainer's
        generator, as in the JAX package, so both draw the same episodes."""
        batcher = EpisodicBatcher(self.train_dataset, self.net.support_train, self.batch_size,
                                  seed=int(self.rng.integers(0, 2**31 - 1)))
        device = self.net.device
        images = device_images(self.train_dataset, device)
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        accs: List[torch.Tensor] = []
        sizes: List[int] = []

        def long(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        if images is not None:
            # Indices only: sampling stays on the host, pixels on the device.
            steps = ((images[long(qidx)], long(qy), images[long(sidx)], long(sy))
                     for qidx, qy, sidx, sy in batcher.epoch_indices(num_steps))
        else:
            steps = prefetch_to_device(
                ((np.asarray(qimg, np.float32), np.asarray(qy, np.int64),
                  np.asarray(simg, np.float32), np.asarray(sy, np.int64))
                 for qimg, qy, simg, sy, _sm in batcher.epoch(num_steps)),
                device, size=prefetch,
            )
        for qimg, qy, simg, sy in steps:
            loss, acc = self.train_step(qimg, qy, simg, sy)
            losses.append(loss)
            accs.append(acc)
            sizes.append(qimg.shape[0])
        self.step_losses = []
        if losses:  # the epoch's one read from the device
            self.step_losses = torch.stack(losses).cpu().tolist()
            for l, a, b in zip(self.step_losses, torch.stack(accs).cpu().tolist(), sizes):
                self.metrics["loss:train"].update_state(l, b)
                self.metrics["acc:train"].update_state(a * 100, b)
        self.train_seconds = time.perf_counter() - t0

    # -- evaluation --------------------------------------------------------------

    def eval_epoch(self, mode: str = "random", num_steps: Optional[int] = None,
                   prefetch: int = 2) -> float:
        """One eval pass in ``mode``; returns its accuracy. ECE is taken
        over the pass's concatenated probabilities."""
        ds = self.val_dataset
        device = self.net.device
        images = device_images(ds, device)
        if images is not None:
            stream = ((images[torch.from_numpy(padded).to(device)], ds.targets[idx])
                      for padded, idx in _eval_indices(len(ds), self.batch_size, num_steps))
        else:
            stream = prefetch_to_device(_host_eval_batches(ds, self.batch_size, num_steps),
                                        device, size=prefetch)
        probs_all, gts = [], []
        for img, label in stream:
            label = torch.as_tensor(label).to(device)
            real = label.shape[0]
            output = self.net.predict(img, mode)[:real]
            self.val_metrics[f"loss:val:{mode}"].update_state(M.nll_loss(output, label), real)
            self.val_metrics[f"acc:val:{mode}"].update_state(
                M.acc(torch.argmax(output, -1), label) * 100, real)
            probs_all.append(torch.exp(output).cpu().numpy())
            gts.append(label.cpu().numpy())
        ece = float(M.ece(np.concatenate(probs_all), np.concatenate(gts))) * 100
        self.val_metrics[f"ece:val:{mode}"].update_state(ece, 1)
        return self.val_metrics[f"acc:val:{mode}"].result()

    def eval_all_modes(self, num_steps: Optional[int] = None) -> float:
        """``precompute`` and an eval pass per mode; returns full-mode
        accuracy (else the first mode's)."""
        self.net.precompute()
        acc_by_mode = {mode: self.eval_epoch(mode, num_steps) for mode in self.eval_modes}
        return acc_by_mode.get("full", next(iter(acc_by_mode.values())))

    def reset_metrics(self) -> None:
        for m in (*self.metrics.values(), *self.val_metrics.values()):
            m.reset_state()
