"""Embedding runtime of the ingest path (port of ``pathway_tpu/models/embed_pipeline.py``).

- :class:`EmbedCache`: an LRU of text → embedding keyed by (model, content
  hash), consulted before the encoder, so duplicate chunks skip the forward.
- :class:`EmbedPipeline.encode_batch`: cache lookups, then the encoder's
  length-sorted ``encode_pipelined`` for the misses.

The query-path encoder service, coalescer and semantic cache are not part of
this port yet.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np


class EmbedCache:
    """Thread-safe LRU of text → embedding keyed by (model, content hash).

    Keys are 128-bit BLAKE2b digests of the text salted with the model name.
    Values are read-only float32 host rows. ``max_entries=0`` disables the
    cache (get always misses, put is a no-op)."""

    def __init__(self, max_entries: int = 50_000, model: str = ""):
        self.max_entries = int(max_entries)
        self._salt = model.encode()
        self._data: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _key(self, text: str) -> bytes:
        return hashlib.blake2b(
            self._salt + b"\x00" + str(text).encode(), digest_size=16
        ).digest()

    def get(self, text: str) -> Optional[np.ndarray]:
        if self.max_entries <= 0:
            return None
        key = self._key(text)
        with self._lock:
            vec = self._data.get(key)
            if vec is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return vec

    def put(self, text: str, vec: np.ndarray) -> None:
        if self.max_entries <= 0:
            return
        row = np.ascontiguousarray(vec, dtype=np.float32)
        row.setflags(write=False)  # shared across rows: must never mutate
        key = self._key(text)
        with self._lock:
            self._data[key] = row
            self._data.move_to_end(key)
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "cache_evictions": self.evictions,
                "cache_size": len(self._data),
            }


class EmbedPipeline:
    """Cache → overlapped length-sorted encode for ingest batches."""

    def __init__(
        self,
        encoder: Any,
        *,
        model: str = "",
        sub_batch: int = 128,
        cache_size: int = 50_000,
    ):
        self.encoder = encoder
        self.sub_batch = int(sub_batch)
        # the quantized-tower mode joins the salt: embeddings cached under one
        # geometry never answer the other
        quant_tag = getattr(encoder, "quant_tag", "") or ""
        self.cache = EmbedCache(cache_size, model=f"{model}|{quant_tag}" if quant_tag else model)
        self._pad_padded = 0.0
        self._pad_real = 0.0
        self._tokenize_s = 0.0

    def encode_batch(self, texts: List[str]) -> np.ndarray:
        """Host float32 (n, dim) embeddings for a batch: cache hits skip the
        forward; misses ride the length-sorted sub-batch path."""
        n = len(texts)
        out = np.empty((n, self.encoder.dim), dtype=np.float32)
        miss_idx: List[int] = []
        for i, t in enumerate(texts):
            hit = self.cache.get(t)
            if hit is None:
                miss_idx.append(i)
            else:
                out[i] = hit
        if miss_idx:
            vecs, stats = self.encoder.encode_pipelined(
                [str(texts[i]) for i in miss_idx], sub_batch=self.sub_batch
            )
            self._pad_padded += stats["padded_tokens"]
            self._pad_real += stats["real_tokens"]
            self._tokenize_s += stats["tokenize_s"]
            for j, i in enumerate(miss_idx):
                out[i] = vecs[j]
                self.cache.put(texts[i], vecs[j])
        return out

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.cache.stats())
        out["padded_tokens"] = self._pad_padded
        out["real_tokens"] = self._pad_real
        out["pad_waste"] = (
            1.0 - self._pad_real / self._pad_padded if self._pad_padded else 0.0
        )
        out["tokenize_s"] = self._tokenize_s
        return out
