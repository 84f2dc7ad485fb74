"""IVF-Flat approximate KNN over a device-resident store (PyTorch + CUDA).

Port of ``pathway_tpu/ops/knn_ivf.py`` (untiered, one device):

- **coarse quantizer**: k-means centroids live on the device; probing is one
  small ``queries @ centroids.T`` matmul + top-k;
- **inverted lists**: the host-side CSR pair (``_csr_offsets``,
  ``_csr_rows``) plus the *paged* device mirror — each cluster's members
  padded to a multiple of ``PAGE`` (128) rows, the page count padded to a
  power of two with a trailing all-pad sentinel page. The layout is the
  reference's, built by the same numpy code, so the two stores agree slot for
  slot given the same centroids;
- **query**: probe → expand probed clusters to page ids → score the pages →
  top-k → map positions back to slots. The scoring stage is the hand-written
  Hopper kernel ``csrc/score_pages.cu`` (:func:`score_pages`); the rest is
  torch ops around it.

Ties: every top-k here breaks ties toward the lower position
(:func:`~pathway_tpu_torch.ops.knn.topk_lowest_first`), as ``lax.top_k``
does, so integer corpora return the reference's slots exactly.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from pathway_tpu_torch.device import GRAPH_CAPTURE_LOCK, graph_streams
from pathway_tpu_torch.ops import _cuda
from pathway_tpu_torch.ops.knn import (
    DenseKNNStore,
    next_pow2,
    pad_queries_pow2,
    topk_lowest_first,
)

_KMEANS_CHUNK = 4096

# rows per packed candidate page: the granularity of the page stream
PAGE = 128

_METRICS = {"l2sq": 0, "cos": 1, "ip": 2}
SCORE_PAGES = "score_pages"
SCORE_PAGES_SOURCE = "score_pages.cu"
_cuda.KERNEL_LAUNCHES.setdefault(SCORE_PAGES, 0)


def _bf16_affinity(rows: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """``2 * (rows_bf16 @ cents_bf16.T) - |c|^2`` as the jitted reference
    computes it: bf16 operands, f32 sums. (Written as a bf16 product cast to
    f32, but XLA folds the cast into the dot and never rounds the sums to
    bf16; rounding them here flips ~0.5% of near-tie assignments.) bf16
    values multiply exactly in f32, so upcasting both operands computes the
    same sums."""
    cn = torch.sum(cents * cents, dim=1)
    prod = rows.to(torch.bfloat16).float() @ cents.to(torch.bfloat16).float().T
    return 2.0 * prod - cn[None, :]


def _kmeans_kernel(
    vectors: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, n_iters: int
) -> torch.Tensor:
    """Lloyd iterations on the device over (``_KMEANS_CHUNK``, d) blocks.

    Assignment is the bf16 affinity argmax (first maximum on ties); the
    centroid sums are one-hot matmuls over the bf16-rounded vectors with f32
    accumulation, as in the reference. A one-hot matmul rather than
    ``index_add_``: float atomics on CUDA sum in a run-dependent order."""
    n, d = vectors.shape
    C = centroids.shape[0]
    cents = centroids
    for _ in range(n_iters):
        sums = torch.zeros((C, d), dtype=torch.float32, device=vectors.device)
        counts = torch.zeros((C,), dtype=torch.float32, device=vectors.device)
        for start in range(0, n, _KMEANS_CHUNK):
            v = vectors[start : start + _KMEANS_CHUNK]
            m = valid[start : start + _KMEANS_CHUNK]
            sim = _bf16_affinity(v, cents)
            sim = torch.where(m[:, None], sim, torch.tensor(-np.inf, device=sim.device))
            a = torch.argmax(sim, dim=1)
            oh = torch.nn.functional.one_hot(a, C).float() * m[:, None].float()
            sums = sums + oh.T @ v.to(torch.bfloat16).float()
            counts = counts + torch.sum(oh, dim=0)
        cents = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), cents
        )
    return cents


def _assign2_kernel(block: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Top-2 nearest centroids per row (primary + spill candidate) by bf16
    affinity, ties to the lower centroid id."""
    sim = _bf16_affinity(block.float(), centroids)
    _, idx = topk_lowest_first(sim, 2)
    return idx.to(torch.int32)


def _pack_pages_kernel(
    data: torch.Tensor, norms: torch.Tensor, valid: torch.Tensor, page_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paged device mirror of the CSR: candidate vectors packed
    cluster-major into (n_pages * PAGE, d), their norms and an additive
    0 / -inf mask shaped (n_pages, PAGE) so the scorer addresses them by page
    id. One gather per index rebuild."""
    safe = torch.clamp(page_rows, min=0).long()
    packed = data[safe].contiguous()
    pn = norms[safe].reshape(-1, PAGE).contiguous()
    ok = (page_rows >= 0) & valid[safe]
    pm = torch.where(ok, 0.0, -np.inf).to(torch.float32).reshape(-1, PAGE).contiguous()
    return packed, pn, pm


def _page_scores_epilogue(dot, pn, pm, qn, metric: str):
    """Metric epilogue, identical in the plain version and the CUDA kernel.
    The f32 square root goes through f64: torch's vectorised CPU ``sqrt`` is
    not correctly rounded (~1% of values differ by an ulp), XLA's and CUDA's
    ``sqrtf`` are, and the f64 root rounded to f32 is."""
    if metric == "l2sq":
        s = 2.0 * dot - pn - qn
    elif metric == "cos":
        s = dot / torch.clamp(torch.sqrt((pn * qn).double()).float(), min=1e-30)
    else:  # ip
        s = dot
    return s + pm


def score_pages_plain(
    packed: torch.Tensor, pn: torch.Tensor, pm: torch.Tensor,
    queries: torch.Tensor, page_ids: torch.Tensor, metric: str,
    slot_chunk: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version of the page scorer: gather each query's pages,
    upcast query and pages to f32, ``einsum`` the dots, apply the epilogue.
    Walks ``slot_chunk`` page slots at a time so the gathered candidate
    tile stays bounded. Returns (q, n_slots * PAGE) f32 scores."""
    qf = queries.float()
    q, n_slots = page_ids.shape
    qn = torch.sum(qf * qf, dim=1)[:, None, None]  # (q, 1, 1)
    lanes = torch.arange(PAGE, device=packed.device)
    parts = []
    for s0 in range(0, n_slots, slot_chunk):
        pid = page_ids[:, s0 : s0 + slot_chunk].long()  # (q, s)
        rows = pid[..., None] * PAGE + lanes  # (q, s, PAGE)
        vecs = packed[rows].float()  # (q, s, PAGE, d)
        dot = torch.einsum("qd,qspd->qsp", qf, vecs)
        parts.append(_page_scores_epilogue(dot, pn[pid], pm[pid], qn, metric))
    return torch.cat(parts, dim=1).reshape(q, n_slots * PAGE)


def score_pages(
    packed: torch.Tensor, pn: torch.Tensor, pm: torch.Tensor,
    queries: torch.Tensor, page_ids: torch.Tensor, metric: str,
) -> torch.Tensor:
    """Score candidate pages: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU (replaces the reference's
    ``_score_pages_pallas``)."""
    if packed.device.type == "cpu":
        return score_pages_plain(packed, pn, pm, queries, page_ids, metric)
    return score_pages_cuda(packed, pn, pm, queries, page_ids, metric)


class PageWork(NamedTuple):
    """The page scorer's work list for one batch, on the batch's device.

    ``rank`` is the running count of the (page, query) pairs that the batch
    holds over the table of all of them, page-major (entry ``page * q +
    query``). So the pairs are numbered from 1 by page, then by query; the
    pair (page, j) exists if ``rank[page * q + j + 1] > rank[page * q + j]``
    and is then number ``rank[page * q + j + 1]``; a page's pairs are the
    numbers ``rank[page * q] + 1 .. rank[(page + 1) * q]``, and a slot of
    query i on page P belongs to pair ``rank[P * q + i + 1]``."""

    rank: torch.Tensor      # (n_pages * q + 1,) int64
    pages: torch.Tensor     # (n_pages,) int64: the probed pages, ascending, then n_pages
    n_probed: torch.Tensor  # (1,) int64: how many pages are probed


def group_page_work(page_ids: torch.Tensor, n_pages: int) -> PageWork:
    """The work list of the (q, n_slots) ``page_ids`` over a store of
    ``n_pages`` pages, built with torch ops on their device and no host
    sync. Every slot of a pair writes the same 1 into the pair table, so
    repeated pages leave one result whatever order the writes land in."""
    q, n_slots = page_ids.shape
    dev = page_ids.device
    rows = torch.arange(1, q + 1, device=dev)  # + 1: rank[k + 1] counts entries 0 .. k
    probed = torch.zeros(n_pages * q + 1, dtype=torch.int32, device=dev)
    probed.index_fill_(0, torch.add(rows[:, None], page_ids, alpha=q).reshape(-1), 1)
    rank = torch.cumsum(probed, dim=0)
    # the k-th probed page is the first whose running count of probed pages passes k
    per_page = rank[::q]  # pairs before each page, and all of them
    seen = torch.cumsum(per_page[1:] > per_page[:-1], dim=0)
    pages = torch.searchsorted(seen, torch.arange(1, n_pages + 1, device=dev))
    return PageWork(rank, pages, seen[-1:])


# CUDA graphs of group_page_work, by (device, stream, page_ids shape, n_pages), newest
# last. The shape's slot count is n_probe * max_pages, so the n_probe halved by
# brownout rung 2 replays a graph of its own, never one built for the full n_probe.
_WORK_GRAPHS: "OrderedDict[tuple, tuple]" = OrderedDict()
_WORK_GRAPHS_KEPT = 8
# held by score_pages_cuda from the graph's replay to the launch that reads its
# buffers, so a call from another thread cannot refill them in between
_SCORER_LOCK = threading.Lock()


def page_work(page_ids: torch.Tensor, n_pages: int) -> PageWork:
    """:func:`group_page_work` as the scorer runs it. On the card its small
    torch ops are captured once per (device, stream, shape) into a CUDA
    graph and replayed, so the host spends one copy and one replay on them.
    The returned tensors are the graph's own buffers: valid until the next call
    of the same shape on the same stream, which stream order puts after
    every kernel launched before it. A caller that launches on them holds
    ``_SCORER_LOCK`` from this call to that launch."""
    if page_ids.device.type != "cuda":
        return group_page_work(page_ids, n_pages)
    dev = page_ids.device
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, tuple(page_ids.shape), n_pages)
    cached = _WORK_GRAPHS.get(key)
    if cached is None:
        static_ids = page_ids.clone()
        side, capture = graph_streams(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):  # lazy initialisation stays out of the capture
            group_page_work(static_ids, n_pages)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with GRAPH_CAPTURE_LOCK, torch.cuda.graph(
            graph, stream=capture, capture_error_mode="thread_local"
        ):
            work = group_page_work(static_ids, n_pages)
        cached = _WORK_GRAPHS[key] = (graph, static_ids, work)
        while len(_WORK_GRAPHS) > _WORK_GRAPHS_KEPT:
            _WORK_GRAPHS.popitem(last=False)
    _WORK_GRAPHS.move_to_end(key)
    graph, static_ids, work = cached
    static_ids.copy_(page_ids)
    graph.replay()
    return work


def check_page_width(d: int, dtype: torch.dtype) -> None:
    """The kernel streams page rows in 16-byte copies: ``d`` must be a
    multiple of 4 for f32 pages and of 8 for bf16 pages (the plain version
    takes any ``d``). Raises ``ValueError`` for other widths."""
    per_copy = 16 // torch.empty((), dtype=dtype).element_size()
    if d % per_copy:
        raise ValueError(f"d={d} must be a multiple of {per_copy} for {dtype} pages "
                         f"on the card (16-byte row copies)")


def score_pages_cuda(
    packed: torch.Tensor, pn: torch.Tensor, pm: torch.Tensor,
    queries: torch.Tensor, page_ids: torch.Tensor, metric: str,
) -> torch.Tensor:
    """Number the batch's (page, query) pairs (:func:`page_work`) and launch
    ``csrc/score_pages.cu`` on the current stream: each distinct page is read
    once and scored once per query that probes it, into a tile per pair, and
    a second launch copies each tile to the pair's slots. ``d`` as
    :func:`check_page_width` allows. Safe to call from several threads."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"score_pages_cuda needs CUDA tensors, got {dev}")
    for name, t in (("pn", pn), ("pm", pm), ("queries", queries), ("page_ids", page_ids)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, packed on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"packed must be float32 or bfloat16, got {packed.dtype}")
    if pn.dtype != torch.float32 or pm.dtype != torch.float32:
        raise ValueError("pn and pm must be float32")
    if queries.dtype != torch.float32:
        raise ValueError("queries must be float32")
    if page_ids.dtype != torch.int32:
        raise ValueError("page_ids must be int32")
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    n_rows, d = packed.shape
    q, n_slots = page_ids.shape
    n_pages = n_rows // PAGE
    if n_rows % PAGE or pn.shape != (n_pages, PAGE) or pm.shape != pn.shape:
        raise ValueError("packed rows must be pages of 128 with matching pn / pm")
    if queries.shape != (q, d):
        raise ValueError(f"queries shape {tuple(queries.shape)} != {(q, d)}")
    if d <= 0 or q <= 0 or n_slots <= 0 or n_pages * q >= 2**31 or q * n_slots >= 2**31:
        raise ValueError(f"unsupported shape q={q} n_slots={n_slots} d={d}")
    check_page_width(d, packed.dtype)
    if packed.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("packed and queries must start on a 16-byte boundary")
    fn = _cuda.load(SCORE_PAGES_SOURCE).pw_score_pages
    if fn.argtypes is None:  # first call: pointers must not be cut to 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((q, n_slots * PAGE), dtype=torch.float32, device=dev)
    tiles = torch.empty(q * n_slots * PAGE + q, dtype=torch.float32, device=dev)  # + |q|^2
    with torch.cuda.device(dev), _SCORER_LOCK:
        work = page_work(page_ids, n_pages)
        rc = fn(
            packed.data_ptr(), 0 if packed.dtype == torch.float32 else 1,
            pn.data_ptr(), pm.data_ptr(), queries.data_ptr(), page_ids.data_ptr(),
            work.rank.data_ptr(), work.pages.data_ptr(), work.n_probed.data_ptr(),
            tiles.data_ptr(), out.data_ptr(), n_pages, q, n_slots, d,
            _METRICS[metric], dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(rc, SCORE_PAGES)
    _cuda.count_launch(SCORE_PAGES)
    return out


def probe_page_ids(
    centroids: torch.Tensor, first_page: torch.Tensor, n_pages: torch.Tensor,
    sentinel: int, queries: torch.Tensor, n_probe: int, max_pages: int,
) -> torch.Tensor:
    """(q, n_probe * max_pages) int32 page ids: each query's ``n_probe``
    nearest clusters (L2 affinity to the centroids), each expanded to
    ``max_pages`` slots; slots past a cluster's page count point at the
    all-pad ``sentinel`` page."""
    cn = torch.sum(centroids * centroids, dim=1)
    aff = 2.0 * queries @ centroids.T - cn[None, :]
    _, probe = topk_lowest_first(aff, n_probe)  # (q, n_probe)
    base = first_page[probe]
    cnt = n_pages[probe]
    span = torch.arange(max_pages, device=queries.device)
    ids = base[..., None] + span[None, None, :]  # (q, n_probe, max_pages)
    page_ids = torch.where(span[None, None, :] < cnt[..., None], ids, sentinel)
    return page_ids.reshape(queries.shape[0], -1).to(torch.int32).contiguous()


def _ivf_query_fused(
    centroids: torch.Tensor,   # (C, d) f32
    first_page: torch.Tensor,  # (C,) int64
    n_pages: torch.Tensor,     # (C,) int64
    packed: torch.Tensor,      # (n_pages_pow2 * PAGE, d) corpus dtype
    pn: torch.Tensor,          # (n_pages_pow2, PAGE) f32 row norms
    pm: torch.Tensor,          # (n_pages_pow2, PAGE) f32 additive mask (0 / -inf)
    packed_rows: torch.Tensor, # (n_pages_pow2 * PAGE,) int64 packed pos -> slot
    queries: torch.Tensor,     # (q, d) f32
    k: int,
    n_probe: int,
    max_pages: int,
    metric: str,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe clusters -> expand to candidate pages -> score -> top-k -> slots.
    ``impl="plain"`` scores with the plain version on any device (the oracle
    the smoke test holds the kernel against)."""
    page_ids = probe_page_ids(
        centroids, first_page, n_pages, pn.shape[0] - 1, queries, n_probe, max_pages
    )
    if impl == "plain":
        scores = score_pages_plain(packed, pn, pm, queries, page_ids, metric)
    else:
        scores = score_pages(packed, pn, pm, queries, page_ids, metric)
    k_eff = min(k, scores.shape[1])
    top_scores, pos = topk_lowest_first(scores, k_eff)
    pg = torch.gather(page_ids.long(), 1, pos // PAGE)
    top_slots = packed_rows[pg * PAGE + pos % PAGE]
    top_slots = torch.where(torch.isfinite(top_scores), top_slots, -1)
    return top_scores, top_slots


class IvfKnnStore(DenseKNNStore):
    """Keyed IVF-Flat store: ``DenseKNNStore``'s storage management plus
    centroid assignments and the CSR / paged inverted lists maintained
    through the flush / grow hooks."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        initial_capacity: int = 1024,
        n_clusters: int = 64,
        n_probe: int = 8,
        train_iters: int = 8,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
    ):
        if device is None or torch.device(device).type == "cuda":
            check_page_width(dim, dtype)  # before ingest, not at the first retrieve
        super().__init__(
            dim, metric=metric, initial_capacity=initial_capacity, dtype=dtype, device=device
        )
        self.n_clusters = max(2, n_clusters)
        self.n_probe = min(n_probe, self.n_clusters)
        # retrains restart from the configured count: splits grow n_clusters
        # within ONE train and must not compound across retrains
        self._n_clusters_base = self.n_clusters
        self.train_iters = train_iters
        self._centroids: torch.Tensor | None = None
        # host mirrors: primary assignment + spill candidate (2nd-nearest)
        self._assign = np.full(self.capacity, -1, dtype=np.int32)
        self._assign2 = np.full(self.capacity, -1, dtype=np.int32)
        self._bucket_cap: int | None = None  # set by _split_oversized at train
        self._trained_at = 0  # corpus size at last (re)train
        # CSR + paged layout (built lazily by _ensure_index)
        self._index_dirty = True
        self._csr_offsets: np.ndarray | None = None
        self._csr_rows: np.ndarray | None = None
        self._first_page: np.ndarray | None = None
        self._n_pages: np.ndarray | None = None
        self._page_rows: np.ndarray | None = None
        self._max_pages = 1
        self._packed: "tuple | None" = None  # device mirror

    # -- DenseKNNStore hooks -------------------------------------------------

    def _after_grow(self, old_capacity: int, extra: int) -> None:
        pad = np.full(extra, -1, dtype=np.int32)
        self._assign = np.concatenate([self._assign, pad])
        self._assign2 = np.concatenate([self._assign2, pad.copy()])
        self._invalidate_index()

    def _after_flush_adds(self, padded_slots: np.ndarray, vecs: torch.Tensor) -> None:
        # assign the new rows unless a retrain will re-assign everything
        if self._centroids is not None:
            top2 = self._assign_rows(vecs)
            self._assign[padded_slots] = top2[:, 0]
            self._assign2[padded_slots] = top2[:, 1]
        self._invalidate_index()

    def _after_flush_removals(self) -> None:
        self._invalidate_index()

    def _invalidate_index(self) -> None:
        self._index_dirty = True
        self._packed = None

    # training runs on a SAMPLE: k-means cost stays bounded at any corpus size
    _TRAIN_SAMPLE_PER_CLUSTER = 32

    def _gather_f32(self, slots: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(self.device)
        return self._data[idx].float()

    def _assign_rows(self, rows: torch.Tensor) -> np.ndarray:
        """Top-2 centroid assignment for ``rows``, chunked so the (chunk, C)
        affinity and the (chunk, dim) block stay within a fixed budget."""
        chunk = max(1024, (1 << 28) // max(self.n_clusters, self.dim, 1))
        parts = []
        for start in range(0, rows.shape[0], chunk):
            parts.append(
                _assign2_kernel(rows[start : start + chunk], self._centroids).cpu().numpy()
            )
        return np.concatenate(parts) if parts else np.zeros((0, 2), dtype=np.int32)

    def _maybe_train(self) -> None:
        n = len(self.slot_of)
        if n == 0:
            return
        needs = self._centroids is None or n >= 2 * max(self._trained_at, 1)
        if not needs:
            return
        self.n_clusters = self._n_clusters_base
        rng = np.random.default_rng(0)
        live = np.fromiter(self.slot_of.values(), dtype=np.int64)
        seeds = rng.choice(live, size=self.n_clusters, replace=len(live) < self.n_clusters)
        # k-means accumulates means: always train in f32 even over a bf16 corpus
        init = self._gather_f32(seeds)
        sample_cap = self.n_clusters * self._TRAIN_SAMPLE_PER_CLUSTER
        if len(live) > sample_cap:
            sample = np.sort(rng.choice(live, size=sample_cap, replace=False))
        else:
            sample = np.sort(live)
        train_vecs = self._gather_f32(sample)
        n_train = len(sample)
        pad = (-n_train) % _KMEANS_CHUNK
        if pad:
            train_vecs = torch.cat(
                [train_vecs, train_vecs.new_zeros((pad, self.dim))]
            )
        train_valid = torch.arange(n_train + pad, device=self.device) < n_train
        self.set_centroids(_kmeans_kernel(train_vecs, train_valid, init, self.train_iters))
        self._trained_at = n

    def set_centroids(self, centroids: Any) -> None:
        """Install (C, dim) centroids: assign the whole corpus to them, split
        oversized clusters and invalidate the layout — the tail of a train.
        Parity tests hand the reference's trained centroids in here."""
        if not isinstance(centroids, torch.Tensor):
            centroids = torch.from_numpy(np.array(centroids, dtype=np.float32))
        self._centroids = centroids.float().to(self.device)
        self.n_clusters = int(self._centroids.shape[0])
        live = np.fromiter(self.slot_of.values(), dtype=np.int64)
        top2 = self._assign_rows(self._data)
        self._assign = top2[:, 0].copy()
        self._assign2 = top2[:, 1].copy()
        self._split_oversized(live)
        self._trained_at = max(self._trained_at, len(live))
        self._invalidate_index()

    @staticmethod
    def _cap_for(n_live: int, n_clusters: int) -> int:
        """Target per-cluster occupancy: ~1.5x the mean, rounded up to pow2."""
        mean = max(1, n_live // max(n_clusters, 1))
        cap = 8
        while cap < (3 * mean + 1) // 2:
            cap *= 2
        return cap

    def _split_oversized(self, live: np.ndarray) -> None:
        """Split clusters past the cap with a host-side 2-means over their
        members; siblings cross-link as each other's spill target."""
        if not len(live):
            return
        cap = self._cap_for(len(live), self.n_clusters)
        self._bucket_cap = cap
        limit = 2 * self.n_clusters  # at most double the cluster count
        cents = self._centroids.float().cpu().numpy().copy()
        for _ in range(6):  # each round halves offenders; 6 covers 64x skew
            al = self._assign[live]
            counts = np.bincount(al, minlength=self.n_clusters)
            over = np.where(counts > cap)[0]
            if not len(over) or self.n_clusters + len(over) > limit:
                break
            order = np.argsort(al, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            new_rows: List[np.ndarray] = []
            for c in over:
                mem = live[order[starts[c] : starts[c] + counts[c]]]
                vecs = self._gather_f32(mem).cpu().numpy()
                # 2-means, host-side (members are a few thousand rows at most)
                c0, c1 = vecs[0], vecs[len(vecs) // 2]
                for _it in range(6):
                    d0 = np.sum((vecs - c0) ** 2, axis=1)
                    d1 = np.sum((vecs - c1) ** 2, axis=1)
                    g1 = d1 < d0
                    if g1.all() or (~g1).all():
                        break
                    c0 = vecs[~g1].mean(axis=0)
                    c1 = vecs[g1].mean(axis=0)
                new_id = self.n_clusters
                self.n_clusters += 1
                self._assign[mem[g1]] = new_id
                self._assign2[mem[g1]] = c
                self._assign2[mem[~g1]] = new_id
                cents[c] = c0
                new_rows.append(c1[None, :])
            if new_rows:
                cents = np.concatenate([cents] + new_rows)
        self._centroids = torch.from_numpy(np.ascontiguousarray(cents, dtype=np.float32)).to(
            self.device
        )
        self.n_probe = min(self.n_probe, self.n_clusters)

    def _ensure_index(self) -> None:
        """Pack live slots into the CSR (+ paged) inverted-list layout; the
        overflow of clusters past ~1.5x the mean spills to each row's
        2nd-nearest centroid first (the reference's code, line for line)."""
        if not self._index_dirty:
            return
        live = np.fromiter(self.slot_of.values(), dtype=np.int64)
        C = self.n_clusters
        counts = np.zeros(C, dtype=np.int64)
        a = np.zeros(0, dtype=np.int64)
        if len(live):
            a = self._assign[live].astype(np.int64)
            a2 = self._assign2[live]
            counts = np.bincount(a, minlength=C)
            cap = self._bucket_cap or self._cap_for(len(live), C)
            over = np.where(counts > cap)[0]
            if len(over):
                a = a.copy()
                order = np.argsort(a, kind="stable")
                starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
                for c in over:
                    tail = order[starts[c] + cap : starts[c] + counts[c]]
                    mv = tail[a2[tail] != c]
                    a[mv] = a2[mv]
                counts = np.bincount(a, minlength=C)
        offsets = np.zeros(C + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        order = np.argsort(a, kind="stable")
        sorted_a = a[order]
        sorted_slots = live[order].astype(np.int32)
        self._csr_offsets = offsets
        self._csr_rows = sorted_slots
        # per-cluster member lists padded to PAGE multiples, packed
        # contiguously; page count padded pow2 with a trailing sentinel page
        n_pages_c = -(-counts // PAGE)  # ceil; empty clusters get 0 pages
        first_page = np.zeros(C, dtype=np.int32)
        if C:
            np.cumsum(n_pages_c[:-1], out=first_page[1:])
        total = int(n_pages_c.sum()) + 1
        pages_pow2 = next_pow2(total)
        page_rows = np.full(pages_pow2 * PAGE, -1, dtype=np.int32)
        if len(live):
            within = np.arange(len(live), dtype=np.int64) - offsets[sorted_a]
            dest = first_page[sorted_a].astype(np.int64) * PAGE + within
            page_rows[dest] = sorted_slots
        self._first_page = first_page
        self._n_pages = n_pages_c.astype(np.int32)
        self._page_rows = page_rows
        self._max_pages = int(max(1, n_pages_c.max() if C else 1))
        self._index_dirty = False
        self._packed = None

    def _ensure_packed(self) -> None:
        """Device mirror of the paged layout: one gather per rebuild."""
        if self._packed is not None:
            return
        dev = self.device
        rows = torch.from_numpy(self._page_rows).to(dev)
        packed, pn, pm = _pack_pages_kernel(self._data, self._norms, self._valid, rows)
        self._packed = (
            packed, pn, pm, rows.long(),
            torch.from_numpy(self._first_page.astype(np.int64)).to(dev),
            torch.from_numpy(self._n_pages.astype(np.int64)).to(dev),
        )

    # -- query paths ---------------------------------------------------------

    def _effective_n_probe(self) -> int:
        """``n_probe`` after the brownout ladder's shift: rung 2 halves the
        probed clusters (``engine/brownout.py``); rung 0 returns it as is."""
        from pathway_tpu_torch.engine.brownout import get_brownout

        return max(1, self.n_probe >> get_brownout().nprobe_shift())

    def scoring_inputs(self, queries: Any) -> Tuple[torch.Tensor, ...]:
        """The page scorer's arguments for one query batch (padded to its
        pow2 bucket) as the query path builds them:
        ``(packed, pn, pm, queries, page_ids)``. For measuring the scorer
        alone."""
        self._ensure_packed()
        packed, pn, pm, _rows, first_page, n_pages = self._packed
        q, _n = pad_queries_pow2(self._as_queries(queries), self.dim)
        q = q.contiguous()
        page_ids = probe_page_ids(
            self._centroids, first_page, n_pages, pn.shape[0] - 1, q,
            self._effective_n_probe(), self._max_pages,
        )
        return packed, pn, pm, q, page_ids

    def _search_device_launch(
        self, queries: Any, k_eff: int, impl: str = "auto"
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused query over pow2-padded query chunks, results left on the
        device. ``impl="plain"`` forces the plain scorer (oracle runs)."""
        self._ensure_packed()
        packed, pn, pm, rows, first_page, n_pages = self._packed
        q_dev = self._as_queries(queries)
        nq = q_dev.shape[0]
        n_probe = self._effective_n_probe()
        cand = n_probe * self._max_pages * PAGE
        k_used = min(next_pow2(max(1, k_eff)), cand)
        # chunk the batch so the (chunk, cand) score matrix stays bounded
        q_chunk = next_pow2(max(8, min(nq, (1 << 26) // max(cand, 1))))
        parts = []
        for start in range(0, max(nq, 1), q_chunk):
            sl, _n = pad_queries_pow2(q_dev[start : start + q_chunk], self.dim)
            parts.append(
                _ivf_query_fused(
                    self._centroids, first_page, n_pages, packed, pn, pm, rows,
                    sl.contiguous(), k_used, n_probe, self._max_pages, self.metric, impl,
                )
            )
        top_scores = torch.cat([p[0] for p in parts])[:nq, :k_eff]
        top_slots = torch.cat([p[1] for p in parts])[:nq, :k_eff]
        return top_scores, top_slots

    def _search_device(self, queries: Any, k_eff: int) -> Tuple[np.ndarray, np.ndarray]:
        top_scores, top_slots = self._search_device_launch(queries, k_eff)
        return top_scores.cpu().numpy(), top_slots.cpu().numpy().astype(np.int64)

    def _prepare_search(self) -> bool:
        """Flush mutations, (re)train if due, build the CSR / paged layout.
        False while the store is empty (nothing trained to search)."""
        self._flush()
        self._maybe_train()
        if self._centroids is None:
            return False
        self._ensure_index()
        return True

    def search_batch(self, queries: Any, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = int(queries.shape[0]) if hasattr(queries, "shape") else len(queries)
        if not self._prepare_search():
            return (
                np.full((n, max(1, k)), -np.inf, dtype=np.float32),
                np.full((n, max(1, k)), -1, dtype=np.int64),
                np.zeros((n, max(1, k)), dtype=bool),
            )
        k_eff = max(1, k)
        scores, idx = self._search_device(queries, k_eff)
        valid = np.isfinite(scores)
        if scores.shape[1] < k_eff:  # fewer candidates than k: pad result shape
            pad = k_eff - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
            valid = np.pad(valid, ((0, 0), (0, pad)), constant_values=False)
        return scores, idx, valid
