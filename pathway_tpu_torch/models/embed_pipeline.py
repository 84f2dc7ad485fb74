"""Embedding runtime of the ingest and query paths (port of ``pathway_tpu/models/embed_pipeline.py``).

Stages in front of ``TorchSentenceEncoder``, counted in the stage counters
of ``engine/telemetry.py``:

1. **Content-hash embed cache** (:class:`EmbedCache`): an LRU keyed on
   (model, hash of the text), consulted before the encoder on both paths.
   Retraction rows are replayed from the engine's per-key memo and never
   reach it.
2. **Semantic query cache** (query path only;
   :class:`~pathway_tpu_torch.models.encoder_service.SemanticQueryCache`):
   exact mode keys on the tokenizer's canonical form, so whitespace / case
   variants of a served query hit without a forward.
3. **Length-sorted ingest** (``TorchSentenceEncoder.encode_pipelined``).
4. **Query serving**: by default the continuously-batched
   :class:`~pathway_tpu_torch.models.encoder_service.EncoderService`
   (``PATHWAY_ENCSVC=off`` gives the deadline coalescer). The
   :class:`QueryCoalescer` stays in front of it as the admission shim: the
   ``max_queue_rows`` cap, the ``overloaded`` probe, the typed shed with an
   honest ``Retry-After`` and the ``embed.shed`` counter.

Counters (``telemetry.stage_snapshot("embed.")``): cache hits / misses /
evictions, semantic hits / misses, coalescer batches / rows / dedup rows,
tokenize and encode times, padded and real tokens, ``embed.svc.*``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.brownout import get_brownout
from pathway_tpu_torch.models.encoder_service import (
    EncoderService,
    SemanticQueryCache,
    _env_flag,
    _env_float,
    _env_int,
    default_canonicalize,
)


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
                telemetry.stage_add("embed.cache_evictions")

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


class EmbedOverloadError(RuntimeError):
    """The embed admission queue is full; the caller should shed load. Raised
    to direct ``QueryCoalescer.embed`` callers; the REST plane probes the
    same cap before admission (``overloaded``) and sheds with 429 there."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class _Request:
    __slots__ = ("texts", "arrived", "event", "rows", "error")

    def __init__(self, texts: List[str]):
        self.texts = texts
        self.arrived = time.monotonic()
        self.event = threading.Event()
        self.rows: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None


class QueryCoalescer:
    """Deadline micro-batcher merging concurrent embed requests into one
    encoder dispatch, or the admission shim in front of an
    :class:`EncoderService`.

    Deadline mode (``service=None``): the oldest queued request anchors a
    window of ``max_wait_ms`` (shrunk by the brownout ladder); requests
    arriving inside it, or while the encoder is busy, join the same dispatch,
    up to ``max_batch`` rows. Duplicate texts encode once; every request gets
    its own rows. ``encode_rows(texts)`` runs on the worker thread;
    ``after_batch(texts, rows)`` runs after the responders are released.

    Shim mode (``service`` set, the pipeline's default): :meth:`embed`
    enforces the admission cap here and submits into the service's queue,
    whose continuous batching replaces the window."""

    def __init__(
        self,
        encode_rows: Callable[[List[str]], Sequence[Any]],
        *,
        max_wait_ms: float = 2.0,
        max_batch: int = 256,
        max_queue_rows: int = 0,
        after_batch: Callable[[List[str], Sequence[Any]], None] | None = None,
        service: Any = None,
    ):
        self._encode_rows = encode_rows
        self.max_wait_ms = float(max_wait_ms)
        self.max_batch = max(1, int(max_batch))
        # rows allowed to wait for the encoder (0 = unbounded); past it
        # embed() sheds instead of queueing
        self.max_queue_rows = max(0, int(max_queue_rows))
        self._after_batch = after_batch
        self._service = service
        # bound on one request's whole wait (0 = none; the wait stays abortable)
        self.wait_timeout_s = float(os.environ.get("PATHWAY_EMBED_WAIT_TIMEOUT_S", "0") or 0)
        self._queue: "deque[_Request]" = deque()
        self._queued_rows = 0
        self._encode_ewma_s = 0.0  # smoothed per-batch encode time (Retry-After)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._closed = False
        self.requests = 0
        self.batches = 0
        self.coalesced_rows = 0
        self.dedup_rows = 0
        self.max_batch_rows = 0
        self.shed_requests = 0

    def _rows_pending(self) -> int:
        """Rows admitted against the cap and not yet answered: the service's
        queue (waiting + in flight) in shim mode, the own queue otherwise."""
        if self._service is not None:
            return int(self._service.queue_depth_rows())
        return self._queued_rows

    def overloaded(self, extra_rows: int = 0) -> bool:
        """Admission probe: would ``extra_rows`` more rows reach
        ``max_queue_rows``? Each probe also feeds the brownout ladder one
        occupancy sample."""
        if not self.max_queue_rows:
            return False
        pending = self._rows_pending()
        get_brownout().observe_occupancy(pending / self.max_queue_rows)
        return pending + extra_rows >= self.max_queue_rows

    def retry_after_s(self, extra_rows: int = 0) -> float:
        """Honest Retry-After: batches needed to drain the queue x (window +
        smoothed encode time), at least 1 s; in shim mode the window term
        drops and the encode time is the service's."""
        rows = self._rows_pending() + extra_rows
        if self._service is not None:
            batches = max(1.0, rows / self._service.max_in_flight)
            per_batch = self._service.encode_ewma_s() or 0.05
        else:
            batches = max(1.0, rows / self.max_batch)
            per_batch = self.max_wait_ms / 1000.0 + (self._encode_ewma_s or 0.05)
        return max(1.0, batches * per_batch)

    # -- submission ----------------------------------------------------------

    def embed(self, texts: List[str], *, enforce_cap: bool = True) -> List[Any]:
        """Blocking: one row per input text, in order. Raises
        :class:`EmbedOverloadError` when ``max_queue_rows`` is set and these
        rows would exceed it. The engine's serving path passes
        ``enforce_cap=False``: its requests were admitted at the REST
        boundary, and raising inside a commit would end the run."""
        if not texts:
            return []
        if self._service is not None:
            return self._embed_via_service(list(texts), enforce_cap)
        req = _Request(list(texts))
        with self._cond:
            if self._closed:
                raise RuntimeError("QueryCoalescer is closed")
            if (
                enforce_cap
                and self.max_queue_rows
                and self._queued_rows + len(texts) > self.max_queue_rows
            ):
                self.shed_requests += 1
                telemetry.stage_add("embed.shed")
                raise EmbedOverloadError(
                    f"embed queue full ({self._queued_rows} rows waiting, cap "
                    f"{self.max_queue_rows})",
                    retry_after_s=self.retry_after_s(len(texts)),
                )
            self._queue.append(req)
            self._queued_rows += len(texts)
            self.requests += 1
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="pathway:embed-coalescer", daemon=True
                )
                self._worker.start()
            self._cond.notify_all()
        self._await(req)
        if req.error is not None:
            raise req.error
        assert req.rows is not None
        return req.rows

    def _embed_via_service(self, texts: List[str], enforce_cap: bool) -> List[Any]:
        """Shim: admission and shed here, batching in the service."""
        with self._cond:
            if self._closed:
                raise RuntimeError("QueryCoalescer is closed")
            if (
                enforce_cap
                and self.max_queue_rows
                and self._rows_pending() + len(texts) > self.max_queue_rows
            ):
                self.shed_requests += 1
                telemetry.stage_add("embed.shed")
                raise EmbedOverloadError(
                    f"embed queue full ({self._rows_pending()} rows pending, "
                    f"cap {self.max_queue_rows})",
                    retry_after_s=self.retry_after_s(len(texts)),
                )
            self.requests += 1
        return self._service.submit(texts, enforce_cap=False)

    def _await(self, req: _Request) -> None:
        """Timed wait, waking every 0.25 s: a request still queued with no
        worker left after :meth:`close` fails typed instead of hanging;
        ``PATHWAY_EMBED_WAIT_TIMEOUT_S`` bounds the whole wait."""
        deadline = time.monotonic() + self.wait_timeout_s if self.wait_timeout_s > 0 else None
        while not req.event.wait(timeout=0.25):
            with self._cond:
                if req.event.is_set():
                    break
                worker = self._worker
                if (
                    self._closed
                    and req in self._queue
                    and (worker is None or not worker.is_alive())
                ):
                    self._queue.remove(req)
                    self._queued_rows -= len(req.texts)
                    req.error = RuntimeError(
                        "QueryCoalescer closed before this request was "
                        "dispatched (no worker left to drain the queue)"
                    )
                    req.event.set()
                    break
            if deadline is not None and time.monotonic() > deadline:
                with self._cond:
                    if req in self._queue:
                        self._queue.remove(req)
                        self._queued_rows -= len(req.texts)
                raise TimeoutError(
                    f"embed request not answered within {self.wait_timeout_s:.0f}s "
                    "(PATHWAY_EMBED_WAIT_TIMEOUT_S)"
                )

    def close(self) -> None:
        """Idempotent. A live worker drains the queue before it exits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- worker --------------------------------------------------------------

    def _gather(self) -> List[_Request]:
        """Wait for work, honour the window, take up to ``max_batch`` rows."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return []
                self._cond.wait(timeout=0.5)
            # the window anchors at the oldest queued request's arrival, and
            # shrinks under brownout
            window_ms = self.max_wait_ms * get_brownout().coalesce_window_scale()
            deadline = self._queue[0].arrived + window_ms / 1000.0
            while sum(len(r.texts) for r in self._queue) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(timeout=remaining)
            take: List[_Request] = []
            rows = 0
            while self._queue and (not take or rows + len(self._queue[0].texts) <= self.max_batch):
                req = self._queue.popleft()
                take.append(req)
                rows += len(req.texts)
            self._queued_rows -= rows
            return take

    def _run(self) -> None:
        while True:
            batch = self._gather()
            if not batch:
                if self._closed:
                    return
                continue
            texts = [t for r in batch for t in r.texts]
            first_of: Dict[str, int] = {}
            unique: List[str] = []
            slot_of = []
            for t in texts:
                j = first_of.setdefault(t, len(unique))
                if j == len(unique):
                    unique.append(t)
                slot_of.append(j)
            try:
                t_enc = time.monotonic()
                with telemetry.stage_timer("embed.coalesce_encode"):
                    out = self._encode_rows(unique)
                enc_s = time.monotonic() - t_enc
                self._encode_ewma_s = (
                    0.8 * self._encode_ewma_s + 0.2 * enc_s if self._encode_ewma_s else enc_s
                )
                rows = [out[j] for j in slot_of]
            except BaseException as exc:  # every waiter of the batch gets the error
                for r in batch:
                    r.error = exc
                    r.event.set()
                continue
            self.batches += 1
            self.coalesced_rows += len(texts)
            self.dedup_rows += len(texts) - len(unique)
            self.max_batch_rows = max(self.max_batch_rows, len(texts))
            telemetry.stage_add("embed.coalesce_batches")
            telemetry.stage_add("embed.coalesce_rows", len(texts))
            if len(texts) > len(unique):
                telemetry.stage_add("embed.coalesce_dedup_rows", len(texts) - len(unique))
            pos = 0
            for r in batch:
                r.rows = rows[pos : pos + len(r.texts)]
                pos += len(r.texts)
                r.event.set()
            if self._after_batch is not None:
                try:
                    self._after_batch(unique, out)
                except Exception:
                    pass  # cache fill is best-effort; responders already released

    def stats(self) -> Dict[str, int]:
        return {
            "coalesce_requests": self.requests,
            "coalesce_batches": self.batches,
            "coalesce_rows": self.coalesced_rows,
            "coalesce_dedup_rows": self.dedup_rows,
            "coalesce_max_batch_rows": self.max_batch_rows,
            "coalesce_shed_requests": self.shed_requests,
        }


class EmbedPipeline:
    """The embed runtime of ingest (``encode_batch``) and query
    (``embed_query_rows``): caches → service (or the deadline coalescer) or
    the length-sorted encode → cache fill.

    Knobs: ``max_wait_ms`` / ``max_batch`` (deadline coalescer), ``sub_batch``
    (ingest sub-batch rows), ``cache_size`` (content LRU entries; 0 disables
    both caches), ``max_queue_rows`` (None = ``PATHWAY_EMBED_MAX_QUEUE_ROWS``,
    4096), ``service_mode`` (None = ``PATHWAY_ENCSVC``, on),
    ``semantic_mode`` / ``semantic_size`` / ``semantic_threshold`` (None =
    ``PATHWAY_ENCSVC_SEMANTIC*``: exact / 4096 / 0.95), and ``tick_ms`` /
    ``max_in_flight`` / ``prewarm`` for the service."""

    def __init__(
        self,
        encoder: Any,
        *,
        model: str = "",
        max_wait_ms: float = 2.0,
        max_batch: int = 256,
        sub_batch: int = 128,
        cache_size: int = 50_000,
        max_queue_rows: "int | None" = None,
        service_mode: "bool | None" = None,
        semantic_mode: "str | None" = None,
        semantic_size: "int | None" = None,
        semantic_threshold: "float | None" = None,
        tick_ms: "float | None" = None,
        max_in_flight: "int | None" = None,
        prewarm: "bool | None" = None,
    ):
        self.encoder = encoder
        self.sub_batch = int(sub_batch)
        # the quantized-tower mode joins the salt and the semantic keys:
        # embeddings cached under one geometry never answer the other
        quant_tag = getattr(encoder, "quant_tag", "") or ""
        self.cache = EmbedCache(cache_size, model=f"{model}|{quant_tag}" if quant_tag else model)
        self._pad_padded = 0.0
        self._pad_real = 0.0
        if max_queue_rows is None:
            max_queue_rows = int(os.environ.get("PATHWAY_EMBED_MAX_QUEUE_ROWS", "4096"))
        if service_mode is None:
            service_mode = _env_flag("PATHWAY_ENCSVC", True)
        self.service = (
            EncoderService(
                encoder,
                tick_ms=tick_ms,
                max_in_flight=max_in_flight,
                prewarm=prewarm,
                after_batch=self._fill_cache_from_device,
            )
            if service_mode
            else None
        )
        if semantic_mode is None:
            semantic_mode = os.environ.get("PATHWAY_ENCSVC_SEMANTIC", "exact") or "exact"
        if semantic_mode not in ("exact", "cosine", "off"):
            semantic_mode = "exact"
        if cache_size <= 0:
            semantic_mode = "off"
        if semantic_size is None:
            semantic_size = _env_int("PATHWAY_ENCSVC_SEMANTIC_SIZE", 4096)
        if semantic_threshold is None:
            semantic_threshold = _env_float("PATHWAY_ENCSVC_SEMANTIC_THRESHOLD", 0.95)
        self.semantic_cache = SemanticQueryCache(
            semantic_size,
            mode=semantic_mode,
            threshold=semantic_threshold,
            canonicalize=getattr(encoder, "canonicalize", None) or default_canonicalize,
            key_tag=quant_tag,
        )
        self.coalescer = QueryCoalescer(
            self._encode_device_rows,
            max_wait_ms=max_wait_ms,
            max_batch=max_batch,
            max_queue_rows=max_queue_rows,
            after_batch=self._fill_cache_from_device,
            service=self.service,
        )

    # -- ingest path ---------------------------------------------------------

    def encode_batch(self, texts: List[str]) -> np.ndarray:
        """Host float32 (n, dim) embeddings for a batch: cache hits skip the
        forward; misses ride the length-sorted sub-batch path."""
        n = len(texts)
        out = np.empty((n, self.encoder.dim), dtype=np.float32)
        miss_idx: List[int] = []
        with telemetry.stage_timer("embed.cache_lookup"):
            for i, t in enumerate(texts):
                hit = self.cache.get(t)
                if hit is None:
                    miss_idx.append(i)
                else:
                    out[i] = hit
        self._stage_cache_counts(n - len(miss_idx), len(miss_idx))
        if miss_idx:
            with telemetry.stage_timer("embed.ingest_encode"):
                vecs, stats = self.encoder.encode_pipelined(
                    [str(texts[i]) for i in miss_idx], sub_batch=self.sub_batch
                )
            telemetry.stage_add_many({
                "embed.tokenize_s": stats["tokenize_s"],
                "embed.padded_tokens": stats["padded_tokens"],
                "embed.real_tokens": stats["real_tokens"],
            })
            self._pad_padded += stats["padded_tokens"]
            self._pad_real += stats["real_tokens"]
            for j, i in enumerate(miss_idx):
                out[i] = vecs[j]
                self.cache.put(texts[i], vecs[j])
        return out

    # -- query path ----------------------------------------------------------

    def embed_query_rows(self, texts: List[str]) -> List[Any]:
        """One embedding per query text. Hits (content hash first, then the
        semantic cache, each promoting into the other) are host rows; misses
        ride the service's continuous batch (or the deadline coalescer) and
        are rows of a device tensor."""
        rows: List[Any] = [None] * len(texts)
        miss_idx: List[int] = []
        sem_hits = 0
        for i, t in enumerate(texts):
            hit = self.cache.get(t)
            if hit is None:
                hit = self.semantic_cache.get(str(t))
                if hit is not None:
                    sem_hits += 1
                    self.cache.put(t, hit)  # this raw text hits the content layer next time
            else:
                # a content hit (maybe filled by ingest) seeds the semantic layer
                self.semantic_cache.seed(str(t), hit)
            if hit is None:
                miss_idx.append(i)
            else:
                rows[i] = hit
        self._stage_cache_counts(len(texts) - len(miss_idx), len(miss_idx))
        if sem_hits:
            telemetry.stage_add("embed.svc.semantic_hits", sem_hits)
        if miss_idx and self.semantic_cache.max_entries > 0:
            telemetry.stage_add("embed.svc.semantic_misses", len(miss_idx))
        if miss_idx:
            # enforce_cap=False: REST admission already probed the cap
            got = self.coalescer.embed([str(texts[i]) for i in miss_idx], enforce_cap=False)
            for i, v in zip(miss_idx, got):
                rows[i] = v
        return rows

    def _encode_device_rows(self, texts: List[str]) -> List[Any]:
        dev = self.encoder.encode_device(texts)
        return [dev[i] for i in range(len(texts))]

    def _fill_cache_from_device(self, texts: List[str], rows: Sequence[Any]) -> None:
        """On the worker, after the responders are released: one
        device→host copy of the batch (restacked from the rows the responders
        got) fills the content and semantic caches."""
        if self.cache.max_entries <= 0 or not texts:
            return
        rows = list(rows[: len(texts)])
        if isinstance(rows[0], torch.Tensor):
            host = torch.stack(rows).float().cpu().numpy()
        else:
            host = np.asarray(np.stack(rows), dtype=np.float32)
        for t, v in zip(texts, host):
            self.cache.put(t, v)
            self.semantic_cache.put(t, v)

    def _stage_cache_counts(self, hits: int, misses: int) -> None:
        """One telemetry add per counter per call, not one per row."""
        if self.cache.max_entries <= 0:
            return
        if hits:
            telemetry.stage_add("embed.cache_hits", hits)
        if misses:
            telemetry.stage_add("embed.cache_misses", misses)

    # -- reporting -----------------------------------------------------------

    def pad_waste_ratio(self) -> float:
        """Fraction of encoded ingest tokens that were padding."""
        if self._pad_padded <= 0:
            return 0.0
        return 1.0 - self._pad_real / self._pad_padded

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        out.update(self.cache.stats())
        out.update(self.coalescer.stats())
        out.update(self.semantic_cache.stats())
        if self.service is not None:
            out.update(self.service.stats())
        out["pad_waste_ratio"] = round(self.pad_waste_ratio(), 4)
        return out
