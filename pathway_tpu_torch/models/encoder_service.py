"""Persistent encoder service: continuous batching and pre-warmed buckets
(port of ``pathway_tpu/models/encoder_service.py``).

1. **Ragged admission queue.** Requests append to a FIFO of variable-length
   text lists and wake the worker at once: no deadline wait. Whatever is
   queued when the worker comes around is packed, length-sorted, into the
   next tick, up to ``max_in_flight`` rows; requests that arrive while the
   card is busy ride the next tick.
2. **Pre-warmed pow2 buckets.** The query forward only sees pow2
   (batch, seq) buckets, so the reachable shapes are finite. A background
   thread walks them at service start (on the card
   :meth:`TorchSentenceEncoder.prewarm_bucket` captures one CUDA graph per
   bucket) and records the wall time as ``embed.svc.prewarm_s``, so the
   first query does not pay it.
3. **Semantic query cache** (:class:`SemanticQueryCache`), above the
   content-hash cache of ``EmbedPipeline``: exact mode keys on the
   tokenizer's canonical form, so a whitespace / case variant of a served
   query hits and gets the bitwise-identical embedding; cosine mode
   (opt-in) also answers near matches by a hashed bag-of-words proxy.

Lifecycle: the worker spawns on the first :meth:`EncoderService.submit`;
:func:`stop_all_workers` (called when ``pw.run`` ends) drains the queue and
joins the worker and pre-warm threads, and the next submit respawns the
worker; :meth:`EncoderService.close` is the permanent variant. Every wait is
timed and can be aborted.

Knobs (constructor arguments, env defaults): ``PATHWAY_ENCSVC``
(``on``/``off``, read by the pipeline), ``PATHWAY_ENCSVC_TICK_MS`` (idle
poll bound; wakeups are notify-driven), ``PATHWAY_ENCSVC_MAX_INFLIGHT``
(rows per tick), ``PATHWAY_ENCSVC_PREWARM`` (``1``/``0``),
``PATHWAY_ENCSVC_PREWARM_MAX_BATCH`` (largest pre-warmed batch bucket),
``PATHWAY_ENCSVC_SEMANTIC`` (``exact``/``cosine``/``off``),
``PATHWAY_ENCSVC_SEMANTIC_SIZE``, ``PATHWAY_ENCSVC_SEMANTIC_THRESHOLD``.

Stage counters: ``embed.svc.*`` (prewarm_s, prewarm_compiles, ticks, rows,
batches, dedup_rows, encode_s / encode_calls; the pipeline adds
semantic_hits / semantic_misses). The reference's histograms, tracing
spans and tick links are not ported.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.profile import histogram
from pathway_tpu_torch.internals.shapes import next_pow2
from pathway_tpu_torch.models.encoder import xxh32


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.lower() not in ("0", "false", "no", "off")


def default_canonicalize(text: str) -> str:
    """Canonical form when the encoder has none: whitespace runs collapsed,
    case folded (the equivalence an uncased tokenizer applies)."""
    return " ".join(str(text).split()).lower()


class SemanticQueryCache:
    """Normalised-text query cache above the content-hash ``EmbedCache``.

    **exact** (default): key = ``canonicalize(text)``; two texts with the
    same key tokenize to the same ids, so a hit is the embedding a forward
    would give. **cosine** (opt-in): on an exact miss, a hashed bag-of-words
    proxy (XXH32 of each word modulo :attr:`PROXY_DIM`) is compared with
    the cached proxies, and a best match ``>= threshold`` answers with its
    embedding (an approximation). **off**: get misses, put does nothing.

    Query path only: ingest (``encode_batch``) and retraction rows (replayed
    from the engine's memo) never consult it. ``key_tag`` (the encoder's
    quantized-tower mode) is folded into every key, so a mode flip misses."""

    #: proxy dimensionality in cosine mode
    PROXY_DIM = 128

    def __init__(
        self,
        max_entries: int = 4096,
        *,
        mode: str = "exact",
        threshold: float = 0.95,
        canonicalize: Callable[[str], str] | None = None,
        key_tag: str = "",
    ):
        if mode not in ("exact", "cosine", "off"):
            raise ValueError(f"semantic cache mode must be exact|cosine|off, got {mode!r}")
        self.mode = mode
        self.max_entries = int(max_entries) if mode != "off" else 0
        self.threshold = float(threshold)
        base_canon = canonicalize or default_canonicalize
        if key_tag:
            self._canon = lambda text: f"{key_tag}\x00{base_canon(text)}"
        else:
            self._canon = base_canon
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._proxies: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.exact_hits = 0
        self.semantic_hits = 0
        self.misses = 0
        self.evictions = 0

    def _proxy(self, canon: str) -> np.ndarray:
        vec = np.zeros(self.PROXY_DIM, dtype=np.float32)
        for word in canon.split():
            vec[xxh32(word) % self.PROXY_DIM] += 1.0
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec

    def get(self, text: str) -> Optional[np.ndarray]:
        if self.max_entries <= 0:
            return None
        key = self._canon(text)
        proxy = self._proxy(key) if self.mode == "cosine" else None
        with self._lock:
            vec = self._data.get(key)
            if vec is not None:
                self._data.move_to_end(key)
                self.exact_hits += 1
                return vec
            if proxy is not None and self._proxies:
                keys = list(self._proxies)
                mat = np.stack([self._proxies[k] for k in keys])
                sims = mat @ proxy
                best = int(np.argmax(sims))
                if float(sims[best]) >= self.threshold:
                    self.semantic_hits += 1
                    self._data.move_to_end(keys[best])
                    self._proxies.move_to_end(keys[best])
                    return self._data[keys[best]]
            self.misses += 1
            return None

    def put(self, text: str, vec: np.ndarray) -> None:
        if self.max_entries <= 0:
            return
        key = self._canon(text)
        row = np.ascontiguousarray(vec, dtype=np.float32)
        row.setflags(write=False)  # shared across queries: must never mutate
        proxy = self._proxy(key) if self.mode == "cosine" else None
        with self._lock:
            self._data[key] = row
            self._data.move_to_end(key)
            if proxy is not None:
                self._proxies[key] = proxy
                self._proxies.move_to_end(key)
            while len(self._data) > self.max_entries:
                old, _ = self._data.popitem(last=False)
                self._proxies.pop(old, None)
                self.evictions += 1

    def seed(self, text: str, vec: np.ndarray) -> None:
        """:meth:`put` unless the canonical key is already cached (the
        unlocked check is benign: a racing double put is idempotent)."""
        if self.max_entries <= 0:
            return
        if self._canon(text) in self._data:
            return
        self.put(text, vec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._proxies.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "semantic_mode": self.mode,
                "semantic_exact_hits": self.exact_hits,
                "semantic_cosine_hits": self.semantic_hits,
                "semantic_misses": self.misses,
                "semantic_evictions": self.evictions,
                "semantic_size": len(self._data),
            }


class _Submission:
    __slots__ = ("texts", "arrived", "event", "rows", "error")

    def __init__(self, texts: List[str]):
        self.texts = texts
        self.arrived = time.monotonic()
        self.event = threading.Event()
        self.rows: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None


#: every live service, so the end of ``pw.run`` can stop idle workers
#: without keeping dead pipelines alive
_services: "weakref.WeakSet[EncoderService]" = weakref.WeakSet()


def stop_all_workers(timeout_s: float = 10.0) -> None:
    """Stop (drain and join) every live service's worker and pre-warm
    threads. Services stay usable: the worker respawns on the next submit."""
    for svc in list(_services):
        svc.stop_worker(timeout_s=timeout_s)


class EncoderService:
    """Persistent continuous-batching worker in front of one encoder.

    ``submit(texts)`` blocks until the worker answers with one row per text
    (rows of ``encoder.encode_device``'s tensor). Each tick packs what is
    queued, up to ``max_in_flight`` rows, length-sorted, duplicates encoded
    once. ``max_queue_rows`` (0 = unbounded) is a local shed cap; the usual
    cap lives in the ``QueryCoalescer`` shim, which reads
    :meth:`queue_depth_rows` and :meth:`encode_ewma_s`."""

    def __init__(
        self,
        encoder: Any,
        *,
        tick_ms: float | None = None,
        max_in_flight: int | None = None,
        sub_batch: int = 64,
        max_queue_rows: int = 0,
        prewarm: bool | None = None,
        prewarm_max_batch: int | None = None,
        after_batch: Callable[[List[str], Sequence[Any]], None] | None = None,
    ):
        self.encoder = encoder
        if tick_ms is None:
            tick_ms = _env_float("PATHWAY_ENCSVC_TICK_MS", 50.0)
        # the idle poll bound, not a batching delay: admission notifies the worker
        self.tick_s = max(0.001, float(tick_ms) / 1000.0)
        if max_in_flight is None:
            max_in_flight = _env_int("PATHWAY_ENCSVC_MAX_INFLIGHT", 256)
        self.max_in_flight = max(1, int(max_in_flight))
        self.sub_batch = max(1, int(sub_batch))
        self.max_queue_rows = max(0, int(max_queue_rows))
        self._after_batch = after_batch
        self.wait_timeout_s = _env_float("PATHWAY_EMBED_WAIT_TIMEOUT_S", 0.0)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[_Submission]" = deque()
        self._queued_rows = 0
        self._inflight_rows = 0
        self._worker: threading.Thread | None = None
        self._stop_requested = False
        self._closed = False
        self._encode_ewma_s = 0.0
        self.requests = 0
        self.ticks = 0
        self.total_rows = 0
        self.batches = 0
        self.dedup_rows = 0
        self.max_tick_rows = 0
        self.shed_requests = 0
        # the pre-warm aborts through its own event: stop_worker must cancel
        # it even when no worker ever spawned
        self._warm = threading.Event()
        self._prewarm_abort = threading.Event()
        self._prewarm_thread: threading.Thread | None = None
        self.prewarm_s = 0.0
        self.prewarm_compiles = 0
        # card memory the pre-warm's graphs hold (reserved after - before)
        self.prewarm_pool_bytes = 0
        self.prewarm_error: Optional[str] = None
        if prewarm is None:
            prewarm = _env_flag("PATHWAY_ENCSVC_PREWARM", True)
        if prewarm_max_batch is None:
            prewarm_max_batch = _env_int("PATHWAY_ENCSVC_PREWARM_MAX_BATCH", 64)
        self.prewarm_max_batch = max(8, int(prewarm_max_batch))
        _services.add(self)
        if prewarm and self._prewarm_shapes():
            self._prewarm_thread = threading.Thread(
                target=self._prewarm_run, name="pathway:encsvc-prewarm", daemon=True
            )
            self._prewarm_thread.start()
        else:
            self._warm.set()

    # -- pre-warm ------------------------------------------------------------

    def _prewarm_shapes(self) -> List[Tuple[int, int]]:
        """Every pow2 (batch, seq) bucket the query path can reach, bounded
        by ``prewarm_max_batch`` x the encoder's ``max_length``. Empty for
        encoders without ``prewarm_bucket`` (mock encoders)."""
        if not hasattr(self.encoder, "prewarm_bucket"):
            return []
        max_batch = next_pow2(min(self.max_in_flight, self.prewarm_max_batch), floor=8)
        max_seq = next_pow2(int(getattr(self.encoder, "max_length", 128)), floor=8)
        shapes = []
        b = 8
        while b <= max_batch:
            s = 8
            while s <= max_seq:
                shapes.append((b, s))
                s *= 2
            b *= 2
        return shapes

    def _prewarm_run(self) -> None:
        """Warm every reachable bucket off the request path (on the card: one
        CUDA graph each). A failure is recorded in ``prewarm_error``; the
        bucket is then captured on first use, which raises the failure to
        the request."""
        t0 = time.perf_counter()
        compiles = pool = 0
        reserved = getattr(self.encoder, "reserved_bytes", lambda: 0)
        try:
            before = reserved()
            for batch, seq in self._prewarm_shapes():
                if self._prewarm_abort.is_set() or self._closed:
                    break  # remaining buckets warm on first use
                self.encoder.prewarm_bucket(batch, seq)
                compiles += 1
            pool = reserved() - before
        except Exception as exc:
            self.prewarm_error = f"{type(exc).__name__}: {exc}"
        finally:
            elapsed = time.perf_counter() - t0
            with self._cond:
                self.prewarm_s += elapsed
                self.prewarm_compiles += compiles
                self.prewarm_pool_bytes += pool
            telemetry.stage_add_many(
                {
                    "embed.svc.prewarm_s": elapsed,
                    "embed.svc.prewarm_compiles": float(compiles),
                }
            )
            self._warm.set()

    def wait_warm(self, timeout_s: float = 300.0) -> bool:
        """Block until the pre-warm finished (True) or ``timeout_s`` passed."""
        return self._warm.wait(timeout=timeout_s)

    @property
    def warm(self) -> bool:
        return self._warm.is_set()

    # -- admission probes (read by the QueryCoalescer shim) ------------------

    def queue_depth_rows(self) -> int:
        """Rows admitted but not yet answered (waiting + in flight); a
        lock-free read."""
        return self._queued_rows + self._inflight_rows

    def encode_ewma_s(self) -> float:
        return self._encode_ewma_s

    # -- submission ----------------------------------------------------------

    def submit(self, texts: List[str], *, enforce_cap: bool = True) -> List[Any]:
        """Blocking: one row per input text, in order. Sheds with
        ``EmbedOverloadError`` when ``max_queue_rows`` is set and would be
        exceeded."""
        if not texts:
            return []
        sub = _Submission(list(texts))
        with self._cond:
            if self._closed:
                raise RuntimeError("EncoderService is closed")
            pending = self._queued_rows + self._inflight_rows
            if enforce_cap and self.max_queue_rows and pending + len(texts) > self.max_queue_rows:
                self.shed_requests += 1
                from pathway_tpu_torch.models.embed_pipeline import EmbedOverloadError

                ticks = max(1.0, (pending + len(texts)) / self.max_in_flight)
                raise EmbedOverloadError(
                    f"encoder service queue full ({pending} rows pending, "
                    f"cap {self.max_queue_rows})",
                    retry_after_s=max(1.0, ticks * (self._encode_ewma_s or 0.05)),
                )
            self._queue.append(sub)
            self._queued_rows += len(texts)
            self.requests += 1
            self._ensure_worker_locked()
            self._cond.notify_all()
        self._await(sub)
        if sub.error is not None:
            raise sub.error
        assert sub.rows is not None
        return sub.rows

    def _ensure_worker_locked(self) -> None:
        # the caller holds self._cond
        if self._worker is None or not self._worker.is_alive():
            self._stop_requested = False
            self._worker = threading.Thread(
                target=self._run, name="pathway:encsvc-worker", daemon=True
            )
            self._worker.start()

    def _await(self, sub: _Submission) -> None:
        """Timed wait, waking every 0.25 s: a submission left with no worker
        (a stop raced the append) respawns it, or fails if the service is
        closed; ``PATHWAY_EMBED_WAIT_TIMEOUT_S`` bounds the whole wait."""
        deadline = (
            time.monotonic() + self.wait_timeout_s if self.wait_timeout_s > 0 else None
        )
        while not sub.event.wait(timeout=0.25):
            with self._cond:
                if sub.event.is_set():
                    break
                worker = self._worker
                worker_dead = worker is None or not worker.is_alive()
                if worker_dead and sub in self._queue:
                    if self._closed:
                        self._queue.remove(sub)
                        self._queued_rows -= len(sub.texts)
                        sub.error = RuntimeError(
                            "EncoderService closed before this submission was "
                            "dispatched (no worker left to drain the queue)"
                        )
                        sub.event.set()
                        break
                    self._ensure_worker_locked()
                    self._cond.notify_all()
            if deadline is not None and time.monotonic() > deadline:
                with self._cond:
                    if sub in self._queue:
                        self._queue.remove(sub)
                        self._queued_rows -= len(sub.texts)
                raise TimeoutError(
                    f"encoder service did not answer within {self.wait_timeout_s:.0f}s "
                    "(PATHWAY_EMBED_WAIT_TIMEOUT_S)"
                )

    # -- worker --------------------------------------------------------------

    def _gather(self) -> Tuple[List[_Submission], int]:
        """Take everything queued, up to ``max_in_flight`` rows (at least one
        submission), and the queue depth seen at wake."""
        with self._cond:
            while not self._queue:
                if self._closed or self._stop_requested:
                    return [], 0
                self._cond.wait(timeout=self.tick_s)
            depth = self._queued_rows
            take: List[_Submission] = []
            rows = 0
            while self._queue and (
                not take or rows + len(self._queue[0].texts) <= self.max_in_flight
            ):
                sub = self._queue.popleft()
                take.append(sub)
                rows += len(sub.texts)
            self._queued_rows -= rows
            self._inflight_rows += rows
            return take, depth

    def _release_inflight(self, rows: int) -> None:
        with self._cond:
            self._inflight_rows -= rows
            self._cond.notify_all()

    def _encode_packed(self, texts: List[str]) -> Tuple[List[Any], int]:
        """One dispatch for a small tick; a large one splits into
        ``sub_batch``-row length-sorted sub-batches, each padded to its own
        pow2 bucket. Returns (rows, dispatches)."""
        n = len(texts)
        if n <= self.sub_batch:
            dev = self.encoder.encode_device(texts)
            return [dev[i] for i in range(n)], 1
        order = sorted(range(n), key=lambda i: len(str(texts[i]).split()))
        rows: List[Any] = [None] * n
        dispatches = 0
        for start in range(0, n, self.sub_batch):
            idx = order[start : start + self.sub_batch]
            dev = self.encoder.encode_device([texts[i] for i in idx])
            for j, i in enumerate(idx):
                rows[i] = dev[j]
            dispatches += 1
        return rows, dispatches

    def _run(self) -> None:
        depth_hist = histogram("pathway_encsvc_queue_depth_rows")
        occ_hist = histogram("pathway_encsvc_tick_occupancy")
        tick_hist = histogram("pathway_encsvc_tick_seconds")
        while True:
            batch, depth = self._gather()
            if not batch:
                with self._cond:
                    # exit only with an empty queue (drain semantics)
                    if (self._closed or self._stop_requested) and not self._queue:
                        self._stop_requested = False
                        self._worker = None
                        self._cond.notify_all()
                        return
                continue
            t_tick = time.perf_counter()
            texts = [t for sub in batch for t in sub.texts]
            n_rows = len(texts)
            # duplicates inside the tick encode once
            first_of: Dict[str, int] = {}
            unique: List[str] = []
            slot_of: List[int] = []
            for t in texts:
                j = first_of.setdefault(t, len(unique))
                if j == len(unique):
                    unique.append(t)
                slot_of.append(j)
            try:
                t_enc = time.monotonic()
                with telemetry.stage_timer("embed.svc.encode"):
                    out, dispatches = self._encode_packed(unique)
                enc_s = time.monotonic() - t_enc
                self._encode_ewma_s = (
                    0.8 * self._encode_ewma_s + 0.2 * enc_s if self._encode_ewma_s else enc_s
                )
                rows = [out[j] for j in slot_of]
            except BaseException as exc:  # every waiter of the tick gets the error
                self._release_inflight(n_rows)
                for sub in batch:
                    sub.error = exc
                    sub.event.set()
                continue
            with self._cond:
                self.ticks += 1
                self.total_rows += n_rows
                self.batches += dispatches
                self.dedup_rows += n_rows - len(unique)
                self.max_tick_rows = max(self.max_tick_rows, n_rows)
                self._inflight_rows -= n_rows
                self._cond.notify_all()
            pos = 0
            for sub in batch:
                sub.rows = rows[pos : pos + len(sub.texts)]
                pos += len(sub.texts)
                sub.event.set()
            # after the responders are released: stage counters and
            # histograms are off the request's latency
            telemetry.stage_add_many(
                {
                    "embed.svc.ticks": 1.0,
                    "embed.svc.rows": float(n_rows),
                    "embed.svc.batches": float(dispatches),
                    "embed.svc.dedup_rows": float(n_rows - len(unique)),
                }
            )
            depth_hist.observe(float(depth))
            occ_hist.observe(n_rows / self.max_in_flight)
            tick_hist.observe(time.perf_counter() - t_tick)
            if self._after_batch is not None:
                try:
                    self._after_batch(unique, out)
                except Exception:
                    pass  # cache fill is best-effort; responders already released

    # -- lifecycle -----------------------------------------------------------

    def stop_worker(self, timeout_s: float = 10.0) -> None:
        """Drain the queue, stop the worker and abort a running pre-warm
        (between buckets). The next submit respawns the worker; every
        admitted submission is answered before the worker exits."""
        self._prewarm_abort.set()
        with self._cond:
            worker = self._worker
            if worker is not None and worker.is_alive():
                self._stop_requested = True
            self._cond.notify_all()
        if worker is not None:
            worker.join(timeout=timeout_s)
        prewarm = self._prewarm_thread
        if prewarm is not None and prewarm is not threading.current_thread():
            prewarm.join(timeout=timeout_s)

    def close(self, timeout_s: float = 10.0) -> None:
        """Permanent and idempotent: drain, stop the worker, refuse submits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.stop_worker(timeout_s=timeout_s)

    def worker_alive(self) -> bool:
        worker = self._worker
        return worker is not None and worker.is_alive()

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "svc_requests": self.requests,
                "svc_ticks": self.ticks,
                "svc_rows": self.total_rows,
                "svc_batches": self.batches,
                "svc_dedup_rows": self.dedup_rows,
                "svc_max_tick_rows": self.max_tick_rows,
                "svc_avg_tick_rows": round(self.total_rows / max(self.ticks, 1), 2),
                "svc_occupancy": round(
                    self.total_rows / max(self.ticks * self.max_in_flight, 1), 4
                ),
                "svc_queue_rows": self._queued_rows + self._inflight_rows,
                "svc_shed_requests": self.shed_requests,
                "svc_prewarm_s": round(self.prewarm_s, 3),
                "svc_prewarm_compiles": self.prewarm_compiles,
                "svc_warm": self._warm.is_set(),
            }
