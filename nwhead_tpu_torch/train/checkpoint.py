"""Checkpoints of the training state, with resume.

Port of ``nwhead_tpu/train/checkpoint.py`` in the port's own format: one
``torch.save`` file ``model.{epoch:04d}`` per saved epoch holding the
model's ``state_dict``, the optimizer's, the step count (the learning-rate
schedule is a function of it) and the epoch, plus a ``model.best`` copy.
The CLI writes a ``.sampler.json`` sidecar beside each one with the
episodic samplers' and the trainer's generator states, so a resumed run
draws the episodes the uninterrupted run would have drawn.

Both files are written as orbax writes the JAX package's checkpoints: into
a temporary name first (``model.NNNN.tmp``, whose last dot-part is not
digits, so ``latest_checkpoint`` never picks it), then moved into place by
``os.replace``. A run killed inside a save leaves the previous checkpoint
as the newest, and ``--resume`` restarts from it. The sidecar follows its
checkpoint, so a kill between the two leaves a checkpoint without one; it
resumes with fresh samplers, as the JAX CLI does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), name)


TMP_SUFFIX = ".tmp"


def _write_atomic(path: str, write) -> None:
    """``write(tmp)`` into ``path + TMP_SUFFIX``, then move it onto ``path``:
    the file at ``path`` is always whole (orbax's tmp-then-rename). A
    failed or interrupted write removes the partial file."""
    tmp = path + TMP_SUFFIX
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(epoch: int, state: Dict[str, Any], ckpt_dir: str,
                    is_best: bool = False) -> str:
    """Save ``state`` (tensors, numbers, nested dicts) with its epoch as
    ``model.{epoch:04d}``, atomically, and copy it to ``model.best`` when
    ``is_best``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, f"model.{epoch:04d}")
    _write_atomic(path, lambda tmp: torch.save({**state, "epoch": epoch}, tmp))
    if is_best:
        shutil.copyfile(path, _path(ckpt_dir, "model.best"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint onto the CPU (``load_state_dict`` moves tensors to
    the parameters' devices)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the newest ``model.NNNN`` checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [n for n in os.listdir(ckpt_dir)
             if n.startswith("model.") and n.split(".")[-1].isdigit()]
    if not cands:
        return None
    return _path(ckpt_dir, max(cands, key=lambda n: int(n.split(".")[-1])))


def save_sampler_state(path: str, support_state: dict, trainer_state: dict) -> None:
    """The ``.sampler.json`` sidecar of checkpoint ``path``, written
    atomically after it (JSON holds numpy PCG64's 128-bit integers
    exactly)."""
    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump({"support": support_state, "trainer": trainer_state}, f)

    _write_atomic(path + ".sampler.json", write)


def load_sampler_state(path: str) -> Optional[dict]:
    """The sidecar of checkpoint ``path``, or None if it has none."""
    if not os.path.exists(path + ".sampler.json"):
        return None
    with open(path + ".sampler.json") as f:
        return json.load(f)
