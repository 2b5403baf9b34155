"""Post-hoc temperature scaling of log-probabilities.

Port of ``nwhead_tpu/ops/calibrate.py``: fit one scalar temperature ``T`` on
held-out log-probs by minimizing the NLL, then serve
``log_softmax(log_probs / T)``. The NW head's ``log(probs + 1e-12)`` are
taken as logits, so ``T = 1`` gives the same distribution back (up to the
floor) and ``T > 1`` flattens an overconfident one.

The fit is the JAX package's golden-section search over ``log T`` in f32:
``lo=-3``, ``hi=3``, 40 iterations, one NLL evaluation each (the interior
point and its NLL carried across iterations), ``T = exp`` of the final
bracket's midpoint. It runs on the log-probs' device.
"""

from __future__ import annotations

import torch

from nwhead_tpu_torch.ops.metrics import nll_loss

_PHI = (5.0**0.5 - 1.0) / 2.0  # golden ratio conjugate


def apply_temperature(log_probs: torch.Tensor, T) -> torch.Tensor:
    """``log_softmax(log_probs / T)`` over the last axis of a (B, C) matrix."""
    return torch.log_softmax(torch.as_tensor(log_probs) / T, dim=-1)


def fit_temperature(log_probs, labels, *, lo: float = -3.0, hi: float = 3.0,
                    iters: int = 40) -> torch.Tensor:
    """The NLL-minimizing temperature of held-out predictions, searched in
    ``[e^lo, e^hi]`` (about [0.05, 20]). ``log_probs (B, C)``, ``labels
    (B,)`` int. Returns a 0-d f32 tensor ``T``."""
    log_probs = torch.as_tensor(log_probs).to(torch.float32)
    labels = torch.as_tensor(labels, device=log_probs.device)

    def nll(log_t: torch.Tensor) -> torch.Tensor:
        return nll_loss(apply_temperature(log_probs, torch.exp(log_t)), labels)

    def f32(v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=log_probs.device)

    a, b = f32(lo), f32(hi)
    c = b - _PHI * (b - a)
    d = a + _PHI * (b - a)
    fc, fd = nll(c), nll(d)
    for _ in range(iters):
        if bool(fc < fd):  # the minimum is in (a, d): d becomes b, c becomes d
            b, d, fd = d, c, fc
            c = b - _PHI * (b - a)
            fc = nll(c)
        else:  # the minimum is in (c, b): c becomes a, d becomes c
            a, c, fc = c, d, fd
            d = a + _PHI * (b - a)
            fd = nll(d)
    return torch.exp((a + b) / 2.0)
