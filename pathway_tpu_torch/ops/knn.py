"""Brute-force KNN over a device-resident vector store (PyTorch).

Port of ``pathway_tpu/ops/knn.py``:

- the store is ONE dense ``(capacity, dim)`` tensor on the device with a
  validity mask and f32 row norms; capacity doubles, jumping straight past a
  bulk insert's target;
- adds and removes stage on the host and flush as one pow2-padded scatter per
  batch, so ingest pays one host→device copy per batch, not per row;
- search is plain torch: ``queries @ data.T``, the metric epilogue, the
  validity mask and a top-k whose ties go to the lower slot, as
  ``lax.top_k`` does.

``LshKnnIndex`` is the reference's random-projection LSH index: buckets on
the host, the candidates' exact re-rank in torch on the store's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.internals.shapes import next_pow2


def topk_lowest_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k, descending, with ties broken toward the LOWER column.

    ``torch.topk`` promises no order among equal values; integer corpora make
    ties common, and the reference (``lax.top_k``) returns the lower index
    first. A stable descending sort keeps equal values in column order."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def pad_queries_pow2(q_dev: torch.Tensor, dim: int) -> Tuple[torch.Tensor, int]:
    """Pad a query batch with zero rows to the next pow2 count (floor 8).
    Returns (padded batch, original row count)."""
    nq = q_dev.shape[0]
    q_pad = next_pow2(max(8, nq))
    if q_pad != nq:
        q_dev = torch.cat([q_dev, q_dev.new_zeros((q_pad - nq, dim))])
    return q_dev, nq


def topk_rows(
    scores: np.ndarray, ids: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row host top-k over (n, m) candidate arrays: (n, k) scores sorted
    descending + their ids, padded with -inf / -1 when m < k; ids of
    non-finite scores are -1."""
    n, m = scores.shape
    kk = min(k, m)
    if kk > 0:
        part = np.argpartition(scores, -kk, axis=1)[:, -kk:]
        psc = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-psc, axis=1)
        top = np.take_along_axis(part, order, axis=1)
        out_s = np.take_along_axis(scores, top, axis=1).astype(np.float32)
        out_i = np.take_along_axis(ids, top, axis=1).astype(np.int64)
    else:
        out_s = np.zeros((n, 0), dtype=np.float32)
        out_i = np.zeros((n, 0), dtype=np.int64)
    if kk < k:
        out_s = np.pad(out_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
        out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    out_i[~np.isfinite(out_s)] = -1
    return out_s, out_i


def pad_pow2(
    slots: np.ndarray, vecs: "np.ndarray | None" = None, extras: "np.ndarray | None" = None
):
    """Pad a scatter batch to a power-of-two bucket (floor 8); padding repeats
    row 0 (duplicate scatter indices with identical values are no-ops)."""
    n = len(slots)
    if n == 0:
        return slots, vecs, extras
    bucket = next_pow2(n, floor=8)
    if bucket != n:
        pad = bucket - n
        slots = np.concatenate([slots, np.full(pad, slots[0], slots.dtype)])
        if vecs is not None:
            vecs = np.concatenate([vecs, np.repeat(vecs[:1], pad, axis=0)])
        if extras is not None:
            extras = np.concatenate([extras, np.repeat(extras[:1], pad, axis=0)])
    return slots, vecs, extras


def pow2_target(capacity: int, target: "int | None") -> int:
    """Next capacity: at least double, jumping straight past ``target``."""
    new_capacity = capacity * 2
    if target is not None:
        while new_capacity < target:
            new_capacity *= 2
    return new_capacity


def search_scores(
    data: torch.Tensor, valid: torch.Tensor, norms: torch.Tensor,
    queries: torch.Tensor, metric: str,
) -> torch.Tensor:
    """(q, cap) metric scores over the whole store, -inf on invalid slots
    (the score half of the reference's ``_search_kernel``).

    A bf16 corpus multiplies bf16 queries with f32 accumulation, as the
    reference's ``preferred_element_type=f32`` dot does: bf16 products are
    exact in f32, so upcasting both operands computes the same sums."""
    if data.dtype == torch.bfloat16:
        scores = queries.to(torch.bfloat16).float() @ data.float().T
    else:
        scores = queries.float() @ data.float().T
    qf = queries.float()
    if metric == "l2sq":
        qn = torch.sum(qf * qf, dim=1, keepdim=True)
        scores = -(qn + norms[None, :] - 2.0 * scores)
    elif metric == "cos":
        qn = torch.linalg.norm(qf, dim=1, keepdim=True)
        scores = scores / torch.clamp(qn * torch.sqrt(norms)[None, :], min=1e-30)
    return torch.where(valid[None, :], scores, torch.tensor(-np.inf, device=scores.device))


class SlotIngestMixin:
    """Host-staged keyed slot assignment.

    Requires the host class to provide ``dim``, ``slot_of``, ``key_of``,
    ``_free``, ``_staged_slots``, ``_staged_vecs``, ``_staged_invalid`` and
    ``_grow()``."""

    def add(self, key: Any, vector: np.ndarray) -> None:
        vector = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vector.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: {vector.shape[0]} != {self.dim}")
        if key in self.slot_of:
            self.remove(key)
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.slot_of[key] = slot
        self.key_of[slot] = key
        self._staged_slots.append(slot)
        self._staged_vecs.append(vector)

    def add_many(self, keys: List[Any], vectors: np.ndarray) -> None:
        """Bulk insert: one staging append for the whole batch."""
        vectors = np.asarray(vectors, dtype=np.float32).reshape(len(keys), self.dim)
        last = {k: i for i, k in enumerate(keys)}  # intra-batch dedup: last write wins
        if len(last) != len(keys):
            keep = sorted(last.values())
            keys = [keys[i] for i in keep]
            vectors = vectors[keep]
        for k in [k for k in keys if k in self.slot_of]:
            self.remove(k)
        if len(self._free) < len(keys):
            self._grow(target=self.capacity + len(keys) - len(self._free))
        slots = [self._free.pop() for _ in range(len(keys))]
        self.slot_of.update(zip(keys, slots))
        self.key_of.update(zip(slots, keys))
        self._staged_slots.extend(slots)
        self._staged_vecs.extend(vectors)

    def remove(self, key: Any) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self.key_of.pop(slot, None)
        self._free.append(slot)
        self._staged_invalid.append(slot)
        # drop a staged add for the same slot if still pending
        if slot in self._staged_slots:
            i = self._staged_slots.index(slot)
            del self._staged_slots[i]
            del self._staged_vecs[i]


class DenseKNNStore(SlotIngestMixin):
    """Keyed dense vector store resident on one device."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        dtype: torch.dtype = torch.float32,
        initial_capacity: int = 1024,
        device: Any = None,
    ):
        if metric not in ("l2sq", "cos", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.capacity = initial_capacity
        self.device = resolve_device(device)
        self._data = torch.zeros((self.capacity, dim), dtype=dtype, device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        self._norms = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        self.slot_of: Dict[Any, int] = {}
        self.key_of: Dict[int, Any] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        # staged updates applied lazily before the next search
        self._staged_vecs: List[np.ndarray] = []
        self._staged_slots: List[int] = []
        self._staged_invalid: List[int] = []

    def __len__(self) -> int:
        return len(self.slot_of)

    def _grow(self, target: int | None = None) -> None:
        new_capacity = pow2_target(self.capacity, target)
        self._flush()
        extra = new_capacity - self.capacity
        dev = self.device
        self._data = torch.cat(
            [self._data, torch.zeros((extra, self.dim), dtype=self.dtype, device=dev)]
        )
        self._valid = torch.cat([self._valid, torch.zeros((extra,), dtype=torch.bool, device=dev)])
        self._norms = torch.cat(
            [self._norms, torch.zeros((extra,), dtype=torch.float32, device=dev)]
        )
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        old_capacity, self.capacity = self.capacity, new_capacity
        self._after_grow(old_capacity, extra)

    def _after_grow(self, old_capacity: int, extra: int) -> None:
        """Subclass hook: capacity geometry just changed."""

    def _flush(self) -> None:
        # staged batches pad to power-of-two buckets (padding rows re-write
        # slot[0] with its own values — a no-op); updates happen in place
        if self._staged_slots:
            slots_np = np.array(self._staged_slots, dtype=np.int64)
            vecs_np = np.stack(self._staged_vecs).astype(np.float32)
            slots_np, vecs_np, _ = pad_pow2(slots_np, vecs_np)
            slots = torch.from_numpy(slots_np).to(self.device)
            vecs = torch.from_numpy(vecs_np).to(self.device)
            self._data[slots] = vecs.to(self.dtype)
            self._norms[slots] = torch.sum(vecs * vecs, dim=1)
            self._valid[slots] = True
            self._staged_slots, self._staged_vecs = [], []
            self._after_flush_adds(slots_np, vecs)
        if self._staged_invalid:
            inv = sorted(set(self._staged_invalid))
            flags_np = np.array([s in self.key_of for s in inv], dtype=bool)
            slots_np = np.array(inv, dtype=np.int64)
            slots_np, _, flags_np = pad_pow2(slots_np, extras=flags_np)
            self._valid[torch.from_numpy(slots_np).to(self.device)] = torch.from_numpy(
                flags_np
            ).to(self.device)
            self._staged_invalid = []
            self._after_flush_removals()

    def _after_flush_adds(self, padded_slots: np.ndarray, vecs: torch.Tensor) -> None:
        """Subclass hook: a staged add batch just scattered into the store."""

    def _after_flush_removals(self) -> None:
        """Subclass hook: staged invalidations just applied."""

    def export_rows(self) -> Tuple[List[Any], np.ndarray]:
        """Every live (key, vector) pair as host arrays (one device gather)."""
        self._flush()
        keys = list(self.slot_of.keys())
        if not keys:
            return keys, np.zeros((0, self.dim), dtype=np.float32)
        slots = torch.from_numpy(np.fromiter(self.slot_of.values(), dtype=np.int64))
        vecs = self._data[slots.to(self.device)].float().cpu().numpy()
        return keys, vecs

    def _as_queries(self, queries: Any) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(self.device)
        return q.reshape(-1, self.dim)

    def search_batch(self, queries: Any, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (scores (q,k), slots (q,k), valid_mask (q,k)); slots map via key_of."""
        self._flush()
        k_eff = max(1, min(k, self.capacity))
        q_dev, nq = pad_queries_pow2(self._as_queries(queries), self.dim)
        scores = search_scores(self._data, self._valid, self._norms, q_dev, self.metric)
        top_scores, top_idx = topk_lowest_first(scores, k_eff)
        scores_np = top_scores[:nq].cpu().numpy()
        idx_np = top_idx[:nq].cpu().numpy().astype(np.int64)
        return scores_np, idx_np, np.isfinite(scores_np)


def _as_vector(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().float().reshape(-1).cpu().numpy()
    if isinstance(value, np.ndarray):
        return value.astype(np.float32).reshape(-1)
    if isinstance(value, (tuple, list)):
        return np.asarray(value, dtype=np.float32)
    raise TypeError(f"expected a vector, got {type(value).__name__}")


class BruteForceKnnIndex:
    """Keyed index over ``DenseKNNStore`` with per-key filter data."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        initial_capacity: int = 1024,
        device: Any = None,
        _store: Any = None,
    ):
        if _store is not None:
            self.store: Any = _store
        else:
            self.store = DenseKNNStore(
                dim, metric=metric, initial_capacity=initial_capacity, device=device
            )
        self.filter_data: Dict[Any, Any] = {}

    def add(self, key: Any, vector: Any, filter_data: Any = None) -> None:
        self.store.add(key, _as_vector(vector))
        if filter_data is not None:
            self.filter_data[key] = filter_data

    def add_many(
        self, keys: List[Any], vectors: Any, filter_data: List[Any] | None = None
    ) -> None:
        """Bulk ingest: one staging append + one capacity jump for the batch."""
        if isinstance(vectors, np.ndarray) and vectors.ndim == 2:
            mat = vectors.astype(np.float32, copy=False)
        else:
            mat = np.stack([_as_vector(v) for v in vectors])
        self.store.add_many(keys, mat)
        if filter_data is not None:
            for k, f in zip(keys, filter_data):
                if f is not None:
                    self.filter_data[k] = f

    def remove(self, key: Any) -> None:
        self.store.remove(key)
        self.filter_data.pop(key, None)

    def build(self) -> None:
        """Apply staged mutations now instead of at the next search."""
        self.store._flush()

    def search(self, query_vector: Any, limit: int, filter_expr: Any = None) -> List[tuple]:
        return self.search_many([query_vector], [limit], [filter_expr])[0]

    def search_many(
        self,
        query_vectors: Any,
        limits: List[int],
        filter_exprs: List[Any] | None = None,
    ) -> List[List[tuple]]:
        """Answer a batch of queries with ONE store search. ``query_vectors``
        is a list of vectors or a (n, dim) array / tensor."""
        n = len(query_vectors)
        if n == 0 or len(self.store) == 0:
            return [[] for _ in range(n)]
        limits = [int(x) for x in limits]
        if max(limits) <= 0:
            return [[] for _ in range(n)]
        has_filter = filter_exprs is not None and any(f is not None for f in filter_exprs)
        overfetch = max(limits) if not has_filter else max(max(limits) * 4, 16)
        overfetch = min(overfetch, max(len(self.store), 1))
        if isinstance(query_vectors, (torch.Tensor, np.ndarray)):
            q: Any = query_vectors
        elif any(isinstance(v, torch.Tensor) for v in query_vectors):
            # device rows of the encoder beside host rows of the embed caches
            dev = next(v.device for v in query_vectors if isinstance(v, torch.Tensor))
            q = torch.stack([
                (v if isinstance(v, torch.Tensor) else torch.from_numpy(_as_vector(v)))
                .reshape(-1).to(device=dev, dtype=torch.float32)
                for v in query_vectors
            ])
        else:
            q = np.stack([_as_vector(v) for v in query_vectors])
        scores, idx, valid = self.store.search_batch(q, overfetch)
        from pathway_tpu_torch.stdlib.indexing.filters import matches_filter

        results: List[List[tuple]] = []
        for qi in range(n):
            if limits[qi] <= 0:
                results.append([])
                continue
            flt = filter_exprs[qi] if filter_exprs is not None else None
            out: List[tuple] = []
            for j in range(idx.shape[1]):
                if not valid[qi, j]:
                    continue
                key = self.store.key_of.get(int(idx[qi, j]))
                if key is None:
                    continue
                if flt is not None and not matches_filter(self.filter_data.get(key), flt):
                    continue
                out.append((key, float(scores[qi, j])))
                if len(out) >= limits[qi]:
                    break
            results.append(out)
        return results


class IvfKnnIndex(BruteForceKnnIndex):
    """Keyed index over the IVF-Flat store, on one device: the untiered
    ``knn_ivf.IvfKnnStore``, or the tiered / int8 ``knn_tiers.
    TieredIvfKnnStore`` when ``tiered`` is true. ``tiered=None`` reads the
    reference's knobs (``knn_tiers.tiering_enabled``: a positive
    ``PATHWAY_IVF_HBM_BUDGET_MB`` or ``PATHWAY_IVF_QUANT=int8``)."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        initial_capacity: int = 1024,
        n_clusters: int = 64,
        n_probe: int = 8,
        device: Any = None,
        tiered: "bool | None" = None,
    ):
        from pathway_tpu_torch.ops.knn_tiers import tiering_enabled

        if tiered is None:
            tiered = tiering_enabled()
        if tiered:
            from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore as store_cls
        else:
            from pathway_tpu_torch.ops.knn_ivf import IvfKnnStore as store_cls
        store = store_cls(
            dim,
            metric=metric,
            initial_capacity=initial_capacity,
            n_clusters=n_clusters,
            n_probe=n_probe,
            device=device,
        )
        super().__init__(dim, metric=metric, initial_capacity=initial_capacity, _store=store)

    def build(self) -> None:
        """Flush and train if due now (and, untiered, build the CSR + paged
        layout and its device mirror), so the first query pays none of it."""
        if self.store._prepare_search() and hasattr(self.store, "_ensure_packed"):
            self.store._ensure_packed()


class LshKnnIndex:
    """Random-projection LSH (port of ``pathway_tpu/ops/knn.py::LshKnnIndex``):
    candidates from bucket intersection, an exact re-rank of the candidate
    rows on the store's device (:func:`score_candidates`).

    The projections and offsets come from ``np.random.default_rng(seed)`` in
    the reference's order, so the bucket ids are the reference's."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        bucket_length: float = 4.0,
        n_or: int = 8,
        n_and: int = 4,
        seed: int = 0,
        device: Any = None,
    ):
        self.dim = dim
        self.metric = metric
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.projections = rng.normal(size=(n_or, n_and, dim)).astype(np.float32)
        self.offsets = rng.uniform(0, bucket_length, size=(n_or, n_and)).astype(np.float32)
        self.bucket_length = bucket_length
        self.n_or = n_or
        self.buckets: List[Dict[tuple, set]] = [dict() for _ in range(n_or)]
        self.vectors: Dict[Any, np.ndarray] = {}
        self.filter_data: Dict[Any, Any] = {}

    def _bucket_ids(self, vector: np.ndarray) -> List[tuple]:
        # (n_or, n_and) integer bucket coordinates
        proj = np.einsum("oad,d->oa", self.projections, vector)
        ids = np.floor((proj + self.offsets) / self.bucket_length).astype(np.int64)
        return [tuple(ids[o]) for o in range(self.n_or)]

    def add(self, key: Any, vector: Any, filter_data: Any = None) -> None:
        vector = _as_vector(vector)
        if key in self.vectors:
            self.remove(key)
        self.vectors[key] = vector
        for o, bid in enumerate(self._bucket_ids(vector)):
            self.buckets[o].setdefault(bid, set()).add(key)
        if filter_data is not None:
            self.filter_data[key] = filter_data

    def add_many(
        self, keys: List[Any], vectors: Any, filter_data: List[Any] | None = None
    ) -> None:
        for i, key in enumerate(keys):
            self.add(key, vectors[i], filter_data[i] if filter_data is not None else None)

    def remove(self, key: Any) -> None:
        vector = self.vectors.pop(key, None)
        if vector is None:
            return
        for o, bid in enumerate(self._bucket_ids(vector)):
            bucket = self.buckets[o].get(bid)
            if bucket:
                bucket.discard(key)
        self.filter_data.pop(key, None)

    def search(self, query_vector: Any, limit: int, filter_expr: Any = None) -> List[tuple]:
        query = _as_vector(query_vector)
        candidates: set = set()
        for o, bid in enumerate(self._bucket_ids(query)):
            candidates |= self.buckets[o].get(bid, set())
        if not candidates:
            return []
        from pathway_tpu_torch.stdlib.indexing.filters import matches_filter

        if filter_expr is not None:
            candidates = {
                c for c in candidates if matches_filter(self.filter_data.get(c), filter_expr)
            }
            if not candidates:
                return []
        cand = list(candidates)
        matrix = torch.from_numpy(np.stack([self.vectors[c] for c in cand])).to(self.device)
        q = torch.from_numpy(query).to(self.device)
        scores = score_candidates(matrix, q, self.metric).cpu().numpy()
        order = np.argsort(-scores)[:limit]
        return [(cand[i], float(scores[i])) for i in order]

    def search_many(
        self,
        query_vectors: Any,
        limits: List[int],
        filter_exprs: List[Any] | None = None,
    ) -> List[List[tuple]]:
        return [
            self.search(q, int(limits[i]), filter_exprs[i] if filter_exprs is not None else None)
            for i, q in enumerate(query_vectors)
        ]


def score_candidates(matrix: torch.Tensor, query: torch.Tensor, metric: str) -> torch.Tensor:
    """Metric scores of candidate rows against one query (the reference's
    ``_score_candidates``, in its order of operations)."""
    scores = matrix @ query
    if metric == "l2sq":
        scores = -(torch.sum(matrix * matrix, dim=1) + torch.sum(query * query) - 2.0 * scores)
    elif metric == "cos":
        scores = scores / torch.clamp(
            torch.linalg.norm(matrix, dim=1) * torch.linalg.norm(query), min=1e-30
        )
    return scores
