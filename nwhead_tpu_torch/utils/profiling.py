"""Tracing and timing hooks.

Port of ``nwhead_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` trace of the host and, on a CUDA
  host, the device (CPU and CUDA activities) written into ``logdir`` as a
  Chrome trace (``trace_<pid>_<n>.json``; open it in Perfetto or
  ``chrome://tracing``);
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``) for host phases such as sampling,
  decode or the device step;
* ``StepTimer``: wall-clock phases with percentile summaries;
  ``phase(..., block=True)`` synchronizes the device of its ``result``
  before it stops the clock, so asynchronous CUDA launches do not
  under-report (JAX's timer reads the result back instead).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch

_traces = itertools.count()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a device is visible; the
    device is synchronized before the trace stops) and write its Chrome
    trace into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{next(_traces)}.json"))


def annotate(name: str):
    """Named span visible in profiler timelines (host phases)."""
    return torch.profiler.record_function(name)


def _sync(result) -> None:
    """Wait for the devices of ``result``'s tensors (a tensor or a nest of
    lists, tuples and dicts of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StepTimer:
    """Wall-clock phase timing with percentile summaries.

    Use ``block=True`` phases for device work: the timer waits for the
    device of ``result`` before it stops the clock."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, result=None, block: bool = False) -> Iterator[None]:
        t = time.perf_counter()
        yield
        if block and result is not None:
            _sync(result)
        self.samples[name].append(time.perf_counter() - t)

    def record(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "total_s": float(arr.sum()),
                "count": int(arr.size),
            }
        return out

    def report(self) -> str:
        lines = ["phase                     mean_ms    p50_ms    p95_ms   total_s     n"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:<24} {s['mean_ms']:>9.3f} {s['p50_ms']:>9.3f} "
                f"{s['p95_ms']:>9.3f} {s['total_s']:>9.2f} {s['count']:>5d}"
            )
        return "\n".join(lines)
