"""Timing for the labs on the card.

The counterpart of ``scripts/timing.py`` and ``scripts/kernel_lab.py``'s
``interleaved_time``: the cases run in turns (round robin), one sample per
case per cycle, so that a drift of the card's clock over the run moves every
case alike, and each case reads the median of its samples. A sample is one
call between two CUDA events, queued behind a spin kernel (the host queues
the call while the card spins, so host overhead does not count), with the L2
cache flushed before it unless asked otherwise. The flush reads a 256 MB
buffer, so that the L2 is left holding clean lines: a flush that writes
(``zero_``) leaves up to 50 MB of dirty lines, whose write-back then shares
the timed call's bandwidth, about 15 us at 3.35 TB/s. The
TPU labs' differential loops (two loop lengths, host readback) worked around
a remote device's round trip and do not carry over.

``paired_ratio`` is ``bench.py:_paired_ratio``: the median over cycles of a
ratio of two cases' samples from the same cycle.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

# Cycles of the spin kernel queued before each timed call, about 2 ms.
SPIN_CYCLES = 4_000_000
FLUSH_BYTES = 256 << 20  # over the H100's 50 MB L2
WARMUP = 3  # untimed calls of each case first: the kernel's build and first launch

Case = Tuple[str, Callable, tuple]


def lab_device(name: str) -> torch.device:
    """The device a lab runs on: ``cuda`` unless the caller asks for the
    CPU; a CUDA request without a card is an error, not a CPU run."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the labs run on the card "
                           "(pass --device cpu for a CPU run of the plain versions)")
    return device


def card_line(device: torch.device) -> str:
    """The card a lab's numbers belong to: ``nvidia-smi``'s name and power
    limit (a card may run below its 700 W), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out.stdout.strip()


def interleaved_time(cases: Sequence[Case], cycles: int = 7, *, flush: bool = True,
                     return_samples: bool = False):
    """Seconds per call of each ``(name, fn, args)`` case, the median over
    ``cycles`` round-robin cycles (see the module docstring). With
    ``return_samples`` also ``{name: [seconds per cycle]}``, for
    ``paired_ratio``. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("interleaved_time times the card: no CUDA device is visible")
    names = [name for name, _, _ in cases]
    if len(set(names)) != len(names):
        raise ValueError(f"case names must be unique: {names}")
    buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if flush else None
    for _, fn, args in cases:
        for _ in range(WARMUP):
            fn(*args)
    events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
    for _ in range(cycles):
        for name, fn, args in cases:
            if buf is not None:
                torch.sum(buf)
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            events.append((name, start, end))
    torch.cuda.synchronize()
    samples: Dict[str, List[float]] = {name: [] for name in names}
    for name, start, end in events:
        samples[name].append(start.elapsed_time(end) * 1e-3)
    med = {name: float(np.median(v)) for name, v in samples.items()}
    return (med, samples) if return_samples else med


def paired_ratio(samples: Dict[str, List[float]], num_name: str, den_name: str,
                 scale: float) -> float:
    """Median over cycles of ``scale * num_sample / den_sample``, the two
    samples taken in the same cycle (``bench.py:_paired_ratio``)."""
    r = sorted(scale * a / b for a, b in zip(samples[num_name], samples[den_name]))
    return r[len(r) // 2]
