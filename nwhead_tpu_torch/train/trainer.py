"""The episodic NW training and evaluation loop, and the FC baseline's.

Port of ``NWTrainer`` and ``FCTrainer`` from ``nwhead_tpu/train/trainer.py``:

* SGD with momentum 0.9, nesterov, and L2 weight decay added to the
  gradient (``torch.optim.SGD``, the update ``optax.chain(
  add_decayed_weights, sgd(nesterov=True))`` makes);
* the milestone schedule ``lr * gamma ** (milestones passed)``, milestones
  in epochs, set before every step from the step count, so it crosses a
  milestone at the same step as optax's ``piecewise_constant_schedule``;
* NLL loss on the log-probs, each step one featurizer batch of query and
  support (``NWModel.forward``);
* an in-memory, transform-free training set lives on the device and a step
  ships only indices; other datasets go through pinned-buffer prefetch
  (``FCTrainer``: gathered on the calling thread, as JAX's);
* each trainer draws and drops the JAX init sample first
  (``draw_init_sample``), so a seeded random transform gives JAX's crops;
* loss and accuracy stay on the device and are read once per epoch;
* eval per mode (random, full and cluster by default; any of
  ``NWNet.predict``'s modes, ensemble, knn and hnsw included) over the validation
  set, its tail batch padded (row 0 on the device path, zero images on the
  host path, as in the JAX package), ECE over the epoch's concatenated
  probabilities x100; ``eval_all_modes`` returns full-mode accuracy, the
  best-checkpoint key.

``FCTrainer`` trains an ``FCNet`` on minibatches with the same optimizer
and schedule: each epoch one permutation of the training set from the
trainer's generator, the remainder dropped, so it picks the JAX package's
indices in its order; eval is one pass over the validation set (loss,
accuracy x100 and ECE x100).

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

from nwhead_tpu_torch.data.datasets import draw_init_sample
from nwhead_tpu_torch.data.pipeline import EpisodicBatcher, device_images, prefetch_to_device
from nwhead_tpu_torch.nw.fc import FCNet
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


def _eval_stream(ds, batch_size: int, num_steps: Optional[int], device, prefetch: int):
    """Eval batches ``(images on device, labels of the real rows)``: from
    the device-resident images where the dataset has them (tail padded
    with row 0), else gathered on the host and prefetched (zero images)."""
    images = device_images(ds, device)
    if images is not None:
        return ((images[torch.from_numpy(padded).to(device)], ds.targets[idx])
                for padded, idx in _eval_indices(len(ds), batch_size, num_steps))
    return prefetch_to_device(_host_eval_batches(ds, batch_size, num_steps), device,
                              size=prefetch)


def _sgd(params, lr: float, weight_decay: float):
    """torch SGD with nesterov momentum 0.9 and L2 weight decay added to
    the gradient over the parameters that train (None when none does)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return None
    return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True,
                           weight_decay=weight_decay)


def _sgd_step(optimizer, lr: float, loss: torch.Tensor) -> None:
    if optimizer is None:
        return
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:
        loss.backward()
    optimizer.step()


def _record_epoch(metrics: dict, losses: List[torch.Tensor], accs: List[torch.Tensor],
                  sizes: List[int]) -> List[float]:
    """The epoch's one read from the device: per-step losses and
    accuracies into the train metrics, weighted by batch size."""
    if not losses:
        return []
    step_losses = torch.stack(losses).cpu().tolist()
    for l, a, b in zip(step_losses, torch.stack(accs).cpu().tolist(), sizes):
        metrics["loss:train"].update_state(l, b)
        metrics["acc:train"].update_state(a * 100, b)
    return step_losses


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
        draw_init_sample(train_dataset, batch_size)
        self.lr_schedule = multistep_lr(lr, milestones, gamma, self.steps_per_epoch)
        if freeze_featurizer:
            net.model.featurizer.requires_grad_(False)
        self.optimizer = _sgd(net.model.parameters(), lr, weight_decay)
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
        _sgd_step(self.optimizer, self.lr_schedule(self.step), loss)
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
        self.step_losses = _record_epoch(self.metrics, losses, accs, sizes)
        self.train_seconds = time.perf_counter() - t0

    # -- evaluation --------------------------------------------------------------

    def eval_epoch(self, mode: str = "random", num_steps: Optional[int] = None,
                   prefetch: int = 2) -> float:
        """One eval pass in ``mode``; returns its accuracy. ECE is taken
        over the pass's concatenated probabilities."""
        device = self.net.device
        probs_all, gts = [], []
        for img, label in _eval_stream(self.val_dataset, self.batch_size, num_steps, device,
                                       prefetch):
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


class FCTrainer:
    """Minibatch training and evaluation of an ``FCNet`` (the JAX
    ``FCTrainer``'s step: NLL on the log-probs, one SGD update). The model
    stays on its device; ``train_epoch`` reads the device once."""

    def __init__(
        self,
        model: FCNet,
        train_dataset,
        val_dataset,
        lr: float = 1e-3,
        batch_size: int = 32,
        milestones: Sequence[int] = (100, 150),
        gamma: float = 0.1,
        weight_decay: float = 1e-4,
        freeze_featurizer: bool = False,
        seed: int = 0,
    ) -> None:
        self.model = model
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":  # f32 convolutions and products in f32, as NWNet
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.steps_per_epoch = max(1, len(train_dataset) // batch_size)
        self.step = 0
        draw_init_sample(train_dataset, batch_size)
        self.lr_schedule = multistep_lr(lr, milestones, gamma, self.steps_per_epoch)
        if freeze_featurizer:
            model.featurizer.requires_grad_(False)
        self.optimizer = _sgd(model.parameters(), lr, weight_decay)
        self.metrics = {k: M.Metric() for k in ("loss:train", "acc:train")}
        self.val_metrics = {k: M.Metric() for k in ("loss:val", "acc:val", "ece:val")}
        self.train_seconds = 0.0  # host time of the last train_epoch, synchronized
        self.step_losses: List[float] = []  # per-step losses of the last train_epoch

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": None if self.optimizer is None else self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        if self.optimizer is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def train_step(self, img: torch.Tensor, label: torch.Tensor):
        """One SGD step on one minibatch on the device: the detached loss
        and accuracy (no host read)."""
        self.model.train()
        log_probs = self.model(img)
        loss = M.nll_loss(log_probs, label)
        _sgd_step(self.optimizer, self.lr_schedule(self.step), loss)
        self.step += 1
        acc = torch.mean((torch.argmax(log_probs.detach(), -1) == label).to(torch.float32))
        return loss.detach(), acc

    def _batches(self, num_steps: Optional[int]):
        """The epoch's minibatches on the device: a permutation from the
        trainer's generator, the remainder dropped; indices into the
        device-resident images, or images gathered (and transformed) on the
        host one batch at a time on the calling thread, as JAX's
        ``FCTrainer`` gathers them: a seeded random transform then draws
        each batch from the generator the init sample drew from."""
        ds, device, bs = self.train_dataset, self.device, self.batch_size
        order = self.rng.permutation(len(ds))
        n_steps = len(ds) // bs
        if num_steps is not None:
            n_steps = min(n_steps, num_steps)
        batches = [order[i * bs:(i + 1) * bs] for i in range(n_steps)]
        images = device_images(ds, device)
        if images is not None:
            for idx in batches:
                idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
                label = torch.from_numpy(np.asarray(ds.targets[idx], np.int64)).to(device)
                yield images[idx_t], label
            return
        for idx in batches:
            img = torch.from_numpy(np.asarray(ds.gather(idx), np.float32)).to(device)
            yield img, torch.from_numpy(np.asarray(ds.targets[idx], np.int64)).to(device)

    def train_epoch(self, num_steps: Optional[int] = None) -> None:
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        accs: List[torch.Tensor] = []
        sizes: List[int] = []
        for img, label in self._batches(num_steps):
            loss, acc = self.train_step(img, label)
            losses.append(loss)
            accs.append(acc)
            sizes.append(img.shape[0])
        self.step_losses = _record_epoch(self.metrics, losses, accs, sizes)
        self.train_seconds = time.perf_counter() - t0

    @torch.inference_mode()
    def eval_epoch(self, num_steps: Optional[int] = None, prefetch: int = 2) -> float:
        """One pass over the validation set in eval mode, the tail batch
        padded and its padding dropped; returns the accuracy. ECE over the
        pass's concatenated probabilities."""
        self.model.eval()
        probs_all, gts = [], []
        for img, label in _eval_stream(self.val_dataset, self.batch_size, num_steps,
                                       self.device, prefetch):
            label = torch.as_tensor(label).to(self.device)
            real = label.shape[0]
            output = self.model(img)[:real]
            self.val_metrics["loss:val"].update_state(M.nll_loss(output, label), real)
            self.val_metrics["acc:val"].update_state(
                M.acc(torch.argmax(output, -1), label) * 100, real)
            probs_all.append(torch.exp(output).cpu().numpy())
            gts.append(label.cpu().numpy())
        ece = float(M.ece(np.concatenate(probs_all), np.concatenate(gts))) * 100
        self.val_metrics["ece:val"].update_state(ece, 1)
        return self.val_metrics["acc:val"].result()

    def reset_metrics(self) -> None:
        for m in (*self.metrics.values(), *self.val_metrics.values()):
            m.reset_state()
