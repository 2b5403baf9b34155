"""Full-mode NW inference over a bank that stays on the host.

Port of ``nwhead_tpu/nw/streaming.py``. The bank arrives chunk by chunk
from any iterable of host arrays (host memory, disk, a remote store); each
chunk is copied to the queries' device and merged into running exact
online-softmax partials ``(m, l, acc)``, so device memory holds one chunk,
never the bank or a ``(B, S)`` score matrix. On the card each chunk runs
K1 ``partials=True`` (``parallel.nw_partials``). The chunks are copied
plainly, as the JAX package copies them; pinned staging is ROADMAP.md
queue 1, item 13b.

Banks that fit the device go through the prepared head
(``ops/fused_nw.py``); banks split over several devices through
``parallel.ShardedSupportBank``. This module covers the third case.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.ops.fused_nw import _NEG_INF
from nwhead_tpu_torch.ops.nw import LOG_FLOOR
from nwhead_tpu_torch.parallel.sharded_bank import nw_partials


def _update_partials(m, l, acc, m_c, l_c, acc_c):
    """Merge one chunk's partials into the running ``(m, l, acc)``
    (``streaming.py:31-43``)."""
    m_new = torch.maximum(m, m_c)
    m_safe = torch.where(m_new > _NEG_INF / 2, m_new, 0.0)
    a_old = torch.where(m > _NEG_INF / 2, torch.exp(m - m_safe), 0.0)
    a_chunk = torch.where(m_c > _NEG_INF / 2, torch.exp(m_c - m_safe), 0.0)
    return m_new, l * a_old + l_c * a_chunk, acc * a_old + acc_c * a_chunk


@torch.inference_mode()
def nw_streaming_log_probs(
    qfeat: torch.Tensor,
    chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
    n_classes: int,
    kernel: str = "euclidean",
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """NW log-probs ``(B, C)`` of ``qfeat (B, D)`` over a streamed bank.

    ``chunks`` yields ``(features (n_i, D), labels (n_i,))`` host arrays.
    Each chunk is padded with masked rows to ``chunk_size`` (default: the
    first chunk's length; a longer chunk raises), so every chunk has one
    shape. The same answer as one pass over the whole bank (the merge is
    exact): ``log(acc / l + 1e-12)``."""
    B, device = qfeat.shape[0], qfeat.device
    f32 = dict(dtype=torch.float32, device=device)
    m = torch.full((B, 1), _NEG_INF, **f32)
    l = torch.zeros((B, 1), **f32)
    acc = torch.zeros((B, n_classes), **f32)
    for feats, labels in chunks:
        feats = np.asarray(feats, dtype=np.float32)
        labels = np.asarray(labels).astype(np.int32)
        n = len(feats)
        if len(labels) != n:
            raise ValueError(f"a chunk of {n} rows with {len(labels)} labels")
        if chunk_size is None:
            chunk_size = n
        pad = chunk_size - n
        if pad < 0:
            raise ValueError(f"chunk of {n} exceeds chunk_size={chunk_size}")
        mask = np.ones(chunk_size, np.float32)
        if pad:
            feats = np.concatenate([feats, np.zeros((pad, feats.shape[1]), np.float32)])
            labels = np.concatenate([labels, np.zeros(pad, np.int32)])
            mask[n:] = 0.0
        part = nw_partials(qfeat, torch.from_numpy(feats).to(device),
                           torch.from_numpy(labels).to(device),
                           torch.from_numpy(mask).to(device), n_classes, kernel=kernel)
        m, l, acc = _update_partials(m, l, acc, *part)
    return torch.log(acc / torch.clamp(l, min=1e-30) + LOG_FLOOR)
