"""The featurized support bank on disk.

Port of ``nwhead_tpu/data/embedding_cache.py`` in the same files and
layout, so a cache directory written by either package loads in the other:
``embeddings.npy`` (S, D), ``labels.npy`` (S,), optionally
``metadata.npy`` (each row's environment) and ``tag.json`` (what the
features were computed with). ``chunks`` walks the bank memory-mapped, the
input of ``nw.streaming.nw_streaming_log_probs`` for a bank larger than
memory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class FeatureBankCache:
    def __init__(self, cache_dir: str) -> None:
        self.cache_dir = cache_dir
        self.emb_path = os.path.join(cache_dir, "embeddings.npy")
        self.lbl_path = os.path.join(cache_dir, "labels.npy")
        self.meta_path = os.path.join(cache_dir, "metadata.npy")
        self.tag_path = os.path.join(cache_dir, "tag.json")

    def exists(self) -> bool:
        return os.path.exists(self.emb_path) and os.path.exists(self.lbl_path)

    def save(self, embeddings: np.ndarray, labels: np.ndarray,
             metadata: Optional[np.ndarray] = None,
             tag: Optional[Dict[str, str]] = None) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        np.save(self.emb_path, np.asarray(embeddings))
        np.save(self.lbl_path, np.asarray(labels))
        if metadata is not None:
            np.save(self.meta_path, np.asarray(metadata))
        if tag is not None:
            with open(self.tag_path, "w") as f:
                json.dump(tag, f)

    def load(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        emb = np.load(self.emb_path)
        lbl = np.load(self.lbl_path)
        meta = np.load(self.meta_path) if os.path.exists(self.meta_path) else None
        return emb, lbl, meta

    def load_tag(self) -> Optional[Dict[str, str]]:
        """What the cached features were computed with, as ``save(tag=...)``
        wrote it (None without a tag). The features are valid only for
        queries featurized the same way: a caller refuses a tag that is not
        its own."""
        if not os.path.exists(self.tag_path):
            return None
        with open(self.tag_path) as f:
            return json.load(f)

    def chunks(self, chunk_size: int = 1024,
               mmap: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``(features, labels)`` chunks of ``chunk_size`` rows, in bank
        order, read memory-mapped unless ``mmap=False``."""
        mode = "r" if mmap else None
        emb = np.load(self.emb_path, mmap_mode=mode)
        lbl = np.load(self.lbl_path, mmap_mode=mode)
        for start in range(0, len(emb), chunk_size):  # copies: writable, off the map
            yield (np.array(emb[start:start + chunk_size]),
                   np.array(lbl[start:start + chunk_size]))
