"""Checkpoints of the training state, with resume.

Port of ``nwhead_tpu/train/checkpoint.py`` in the port's own format: one
``torch.save`` file ``model.{epoch:04d}`` per saved epoch holding the
model's ``state_dict``, the optimizer's, the step count (the learning-rate
schedule is a function of it) and the epoch, plus a ``model.best`` copy.
The CLI writes a ``.sampler.json`` sidecar beside each one with the
episodic samplers' and the trainer's generator states, so a resumed run
draws the episodes the uninterrupted run would have drawn.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), name)


def save_checkpoint(epoch: int, state: Dict[str, Any], ckpt_dir: str,
                    is_best: bool = False) -> str:
    """Save ``state`` (tensors, numbers, nested dicts) with its epoch as
    ``model.{epoch:04d}``, and copy it to ``model.best`` when ``is_best``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, f"model.{epoch:04d}")
    torch.save({**state, "epoch": epoch}, path)
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
    """The ``.sampler.json`` sidecar of checkpoint ``path`` (JSON holds
    numpy PCG64's 128-bit integers exactly)."""
    with open(path + ".sampler.json", "w") as f:
        json.dump({"support": support_state, "trainer": trainer_state}, f)


def load_sampler_state(path: str) -> Optional[dict]:
    """The sidecar of checkpoint ``path``, or None if it has none."""
    if not os.path.exists(path + ".sampler.json"):
        return None
    with open(path + ".sampler.json") as f:
        return json.load(f)
