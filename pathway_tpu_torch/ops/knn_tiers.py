"""Tiered IVF residency: card-hot / host-cold / frozen-spill cluster pages
(port of ``pathway_tpu/ops/knn_tiers.py``).

- **Primary storage is per-cluster page blocks** on the host: each cluster
  owns a pow2-capacity ``(rows, dim)`` block (append in place, validity mask
  for removals, per-cluster compaction past 50% dead), so churn touches only
  the clusters it names, never a global layout.
- **Three tiers.** *Hot*: clusters whose payload also lives on the card,
  bounded by ``PATHWAY_IVF_HBM_BUDGET_MB`` (0 = unbounded). *Cold*: host
  blocks. *Frozen spill* (optional): idle, churn-free clusters serialized to
  an object store (``attach_spill`` or ``PATHWAY_IVF_SPILL_DIR``) and
  dropped from RAM.
- **Every probed block is scored on the card by the same kernel**
  (``ops/score_blocks.py``, ``csrc/score_blocks.cu``), one launch per search
  batch. A hot block is read where it lives; a cold block's payload is
  staged through pinned host memory onto the card for that search; a frozen
  one is loaded from the spill store first. Residency changes only where the
  bytes come from, never the arithmetic, so **residency never changes
  results**, bitwise. There is no host scoring path and no first-use parity
  probe that could downgrade to one: a kernel that fails raises.
- **Probe-frequency EWMA drives residency**; promotion follows probes, the
  budget evicts in insertion order, and a browned-out probe set (rung 2)
  never promotes. A background ``Prefetcher`` thread unspills and promotes;
  its card copies run on a stream of their own, and the scoring stream waits
  on each mirror's event.
- **Incremental maintenance** (recenter / re-assign / split / merge /
  compact / int8 scale recalibration, per drifted cluster) and a
  **background rebuild** that swaps generations at a commit boundary.
- **int8** (``PATHWAY_IVF_QUANT=int8``): per-page codes build a shortlist
  (the int8 coarse probe and block scorer, exact integer dots), which the
  host rescores exactly from the fp32 rows (``knn_quant.rescore_pairs``).

The metrics plane is the reference's: flight-recorder events
(``quant_swap``, ``index_rebuild``, ``index_swap``, torn or not) and the
histograms ``pathway_ivf_prefetch_stall_seconds``, ``_tier_hit_ratio``,
``_tier_occupancy_ratio``, ``_quant_rescore_depth`` and
``_quant_recall_ratio``, beside the ``stats`` and ``index.*`` counters.

Chaos plans (``internals/chaos.py``) reach three of its paths, as in the
reference: ``quant`` drops a recalibration's new sidecars before they
install, ``tier_swap_torn`` abandons a generation swap, and ``rebuild_kill``
kills the process inside the background rebuild (``begin_rebuild_attempt``
counts the rebuilds that ``at`` names).

Not ported here: descriptors and replication (``iter_export_fragments``).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from itertools import repeat as _repeat
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.profile import get_flight_recorder, histogram
from pathway_tpu_torch.internals.chaos import get_chaos
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.shapes import next_pow2
from pathway_tpu_torch.ops import knn_quant
from pathway_tpu_torch.ops.knn import topk_rows
from pathway_tpu_torch.ops.knn_ivf import _KMEANS_CHUNK, _assign2_kernel, _kmeans_kernel
from pathway_tpu_torch.ops.knn_quant import quant_mode, rescore_k
from pathway_tpu_torch.ops.score_blocks import (
    BlockGroups,
    check_row_width,
    quant_score_blocks,
    score_blocks,
)

PAGE = 128  # residency granularity mirrors the packed-page layout of knn_ivf

# sentinel centroid for merged-away clusters: far enough that the coarse
# affinity is hugely negative, small enough that |c|^2 stays finite in f32
_DEAD_CENTROID = 1e18


class TieredIndexError(RuntimeError):
    """Typed failure of the tiered index machinery (spill tier unreachable,
    rebuild worker died): callers triage by type, never by repr."""


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def tiering_enabled() -> bool:
    """``PATHWAY_IVF_TIERED``: ``on`` / ``off`` / ``auto`` (default: tiered
    exactly when an HBM budget is configured or a quantization mode is opted
    in; an unknown ``PATHWAY_IVF_QUANT`` raises ``QuantConfigError``)."""
    mode = _env("PATHWAY_IVF_TIERED", "auto").lower()
    if mode in ("on", "1", "true", "yes"):
        return True
    if mode in ("off", "0", "false", "no"):
        return False
    if hbm_budget_bytes() > 0:
        return True
    return quant_mode() != "off"


def hbm_budget_bytes() -> int:
    """``PATHWAY_IVF_HBM_BUDGET_MB`` as bytes; 0 = unbounded hot tier."""
    try:
        return int(float(_env("PATHWAY_IVF_HBM_BUDGET_MB", "0")) * (1 << 20))
    except ValueError:
        return 0


_hbm_budget_env = hbm_budget_bytes  # the store's parameter shadows the name


def _prefetch_enabled() -> bool:
    return _env("PATHWAY_IVF_PREFETCH", "on").lower() not in (
        "off", "0", "false", "no",
    )


def _ewma_alpha() -> float:
    try:
        return min(1.0, max(0.01, float(_env("PATHWAY_IVF_EWMA_ALPHA", "0.2"))))
    except ValueError:
        return 0.2


def _cluster_drift_threshold() -> float:
    try:
        return max(0.05, float(_env("PATHWAY_IVF_CLUSTER_DRIFT", "0.5")))
    except ValueError:
        return 0.5


def _rebuild_drift_threshold() -> float:
    try:
        return max(0.1, float(_env("PATHWAY_IVF_REBUILD_DRIFT", "1.0")))
    except ValueError:
        return 1.0


def _spill_ewma_threshold() -> float:
    try:
        return float(_env("PATHWAY_IVF_SPILL_EWMA", "0.01"))
    except ValueError:
        return 0.01


# ---------------------------------------------------------------------------
# frozen-spill tier: a minimal filesystem object store (put / get / list /
# delete) for PATHWAY_IVF_SPILL_DIR; any such store attaches via attach_spill
# ---------------------------------------------------------------------------


class DirSpillStore:
    """Directory-backed object store for the frozen tier. Writes are atomic
    (tmp + rename): a torn spill never serves a half-written block."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> "bytes | None":
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def list(self, prefix: str) -> List[str]:
        pref = prefix.replace("/", "__")
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [n.replace("__", "/") for n in names if n.startswith(pref)]

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# cluster page blocks
# ---------------------------------------------------------------------------


class _ClusterPages:
    """One cluster's rows as an appendable pow2-capacity host block.

    ``vecs[:n]`` rows are write-once (an append lands past ``n``; a re-add is
    remove + append), so a rebuild snapshot of ``(vecs, n, valid.copy())``
    reads a consistent corpus without copying vectors. With ``quant=True``
    the block also carries the derived int8 mirror: ``qvecs`` codes plus
    per-page ``qscale`` / ``qzero`` sidecars; the fp32 rows stay the source
    of truth."""

    __slots__ = (
        "slots", "vecs", "norms", "valid", "n", "n_live", "mutations",
        "quant", "qvecs", "qscale", "qzero", "_qsrow", "_maskadd",
    )

    def __init__(self, dim: int, cap: int = PAGE, *, quant: bool = False):
        cap = next_pow2(max(PAGE, cap))
        self.slots = np.full(cap, -1, dtype=np.int64)
        self.vecs = np.zeros((cap, dim), dtype=np.float32)
        self.norms = np.zeros(cap, dtype=np.float32)
        self.valid = np.zeros(cap, dtype=bool)
        self.n = 0
        self.n_live = 0
        # bumped on every append / invalidate / recalibration: a card mirror
        # built off-lock installs only while the count it captured holds
        self.mutations = 0
        self.quant = bool(quant)
        if self.quant:
            n_pages = max(1, cap // PAGE)
            self.qvecs: "np.ndarray | None" = np.zeros((cap, dim), dtype=np.int8)
            self.qscale: "np.ndarray | None" = np.ones(n_pages, dtype=np.float32)
            self.qzero: "np.ndarray | None" = np.zeros(n_pages, dtype=np.float32)
        else:
            self.qvecs = None
            self.qscale = None
            self.qzero = None
        self._qsrow: "np.ndarray | None" = None
        self._maskadd: "Tuple[int, np.ndarray] | None" = None

    @property
    def nbytes(self) -> int:
        """The bytes the hot budget prices: the card payload's capacity (int8
        codes, sidecars and norms under quant; fp32 rows and norms
        otherwise) plus the slot ids, as the reference counts them."""
        if self.quant:
            return int(
                self.qvecs.nbytes + self.qscale.nbytes + self.qzero.nbytes
                + self.norms.nbytes + self.slots.nbytes
            )
        return int(self.vecs.nbytes + self.norms.nbytes + self.slots.nbytes)

    def qsrow(self, n: int) -> np.ndarray:
        """Cached per-row expansion of the per-page scales, rows [0:n]."""
        if self._qsrow is None:
            self._qsrow = knn_quant.row_scales(self.qscale, len(self.slots))
        return self._qsrow[:n]

    def maskadd(self, n: int) -> np.ndarray:
        """Additive validity mask (0.0 live / -inf dead) over rows [0:n],
        keyed on ``mutations``."""
        cached = self._maskadd
        if cached is None or cached[0] != self.mutations or len(cached[1]) != n:
            arr = np.where(
                self.valid[:n], np.float32(0.0), np.float32(-np.inf)
            ).astype(np.float32)
            self._maskadd = cached = (self.mutations, arr)
        return cached[1]

    def payload(self) -> Tuple[np.ndarray, ...]:
        """The scorer's host payload of rows [0:n]: ``(codes, row_scales,
        norms, mask)`` for int8 blocks, ``(vecs, norms, mask)`` for fp32."""
        n = self.n
        if self.quant:
            return (self.qvecs[:n], self.qsrow(n), self.norms[:n], self.maskadd(n))
        return (self.vecs[:n], self.norms[:n], self.maskadd(n))

    def _drop_quant_caches(self) -> None:
        self._qsrow = None

    def _requantize_pages(self, pages: "range | np.ndarray") -> None:
        """Re-derive codes + scale for exactly the named pages."""
        cap = len(self.slots)
        for p in pages:
            lo, hi = p * PAGE, min((p + 1) * PAGE, cap)
            s = knn_quant.page_scale(self.vecs[lo:hi])
            self.qscale[p] = np.float32(s)
            self.qvecs[lo:hi] = knn_quant.quantize_rows(self.vecs[lo:hi], s)
        self._drop_quant_caches()

    def append(self, slots: np.ndarray, vecs: np.ndarray, norms: np.ndarray) -> int:
        """Append rows; returns the first position. Grows pow2 (the old
        arrays stay valid for any rebuild snapshot holding them)."""
        need = self.n + len(slots)
        if need > len(self.slots):
            cap = next_pow2(need)
            dim = self.vecs.shape[1]
            new_slots = np.full(cap, -1, dtype=np.int64)
            new_vecs = np.zeros((cap, dim), dtype=np.float32)
            new_norms = np.zeros(cap, dtype=np.float32)
            new_valid = np.zeros(cap, dtype=bool)
            new_slots[: self.n] = self.slots[: self.n]
            new_vecs[: self.n] = self.vecs[: self.n]
            new_norms[: self.n] = self.norms[: self.n]
            new_valid[: self.n] = self.valid[: self.n]
            self.slots, self.vecs = new_slots, new_vecs
            self.norms, self.valid = new_norms, new_valid
            if self.quant:
                n_pages = max(1, cap // PAGE)
                new_qvecs = np.zeros((cap, dim), dtype=np.int8)
                new_qscale = np.ones(n_pages, dtype=np.float32)
                new_qzero = np.zeros(n_pages, dtype=np.float32)
                new_qvecs[: self.n] = self.qvecs[: self.n]
                old_pages = len(self.qscale)
                new_qscale[:old_pages] = self.qscale
                new_qzero[:old_pages] = self.qzero
                self.qvecs, self.qscale, self.qzero = new_qvecs, new_qscale, new_qzero
                self._drop_quant_caches()
        first = self.n
        self.slots[first:need] = slots
        self.vecs[first:need] = vecs
        self.norms[first:need] = norms
        self.valid[first:need] = True
        self.n = need
        self.n_live += len(slots)
        self.mutations += 1
        if self.quant:
            self._requantize_pages(range(first // PAGE, (need - 1) // PAGE + 1))
        return first

    def invalidate(self, pos: int) -> None:
        if self.valid[pos]:
            self.valid[pos] = False
            self.n_live -= 1
            self.mutations += 1

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        mask = self.valid[: self.n]
        return self.slots[: self.n][mask], self.vecs[: self.n][mask], self.norms[: self.n][mask]

    def to_blob(self) -> bytes:
        slots, vecs, norms = self.live_rows()
        payload = {"slots": slots, "vecs": vecs, "norms": norms}
        if self.quant:
            # only compact blocks freeze (n == n_live): the codes and sidecars
            # serialize verbatim, so a recalibrated scale survives the freeze
            payload["qvecs"] = self.qvecs[: self.n]
            payload["qscale"] = self.qscale
            payload["qzero"] = self.qzero
        return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_blob(cls, dim: int, blob: bytes, *, quant: bool = False) -> "_ClusterPages":
        raw = pickle.loads(blob)
        n = len(raw["slots"])
        block = cls(dim, cap=max(PAGE, n), quant=quant)
        if n:
            block.append(raw["slots"], raw["vecs"], raw["norms"])
        if quant and "qvecs" in raw:
            # the serialized codes and sidecars win over the append-time
            # re-derivation; a blob written before quant keeps re-derived codes
            block.qvecs[:n] = raw["qvecs"]
            pages = min(len(raw["qscale"]), len(block.qscale))
            block.qscale[:pages] = raw["qscale"][:pages]
            block.qzero[:pages] = raw["qzero"][:pages]
            block._drop_quant_caches()
        return block


# ---------------------------------------------------------------------------
# block payloads on the scoring device
# ---------------------------------------------------------------------------


class _Mirror:
    """A hot cluster's payload on the card: the tensors of rows [0:n] and
    the event that marks the end of their copy (made on the prefetch
    stream; the scoring stream waits on it)."""

    __slots__ = ("tensors", "event", "n")

    def __init__(self, tensors: Tuple[torch.Tensor, ...], event: Any, n: int):
        self.tensors = tensors
        self.event = event
        self.n = n


def _to_device(arrays: Tuple[np.ndarray, ...], device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Host arrays as tensors on ``device``: zero-copy views on the CPU; on
    the card, a pinned copy each, moved on the current stream without a
    host sync (the host allocator keeps each pinned buffer until its copy
    has run)."""
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if device.type == "cpu":
        return tensors
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)


class _QueryStage:
    """A search's query data sent to the scoring device in one copy. The
    arrays are packed, each from a 16-byte boundary (the kernels copy rows
    in 16-byte pieces), into one host buffer that the store owns, grown by
    powers of two and pinned when the device is a card; one ``non_blocking``
    copy on the current stream sends it, and the caller gets views of the
    copy. The buffer is rewritten only once the event recorded after its
    last copy has completed. The probe's affinity comes back through a
    second such buffer and an explicit sync of the stream. On the CPU the
    views are of the host buffer itself: nothing is copied or pinned.
    ``sends`` counts the buffers sent (one per search: one host-to-card
    copy of query data on a card). Callers hold the store's search lock."""

    _TYPES = {"b": torch.int8, "f": torch.float32}  # by numpy type code

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.host: Optional[torch.Tensor] = None  # int8, the packed queries
        self.host_np: Optional[np.ndarray] = None
        self.back: Optional[torch.Tensor] = None  # float32, the affinity
        self.back_np: Optional[np.ndarray] = None
        self.sent: Any = None  # the event after the last copy of ``host``
        self.stream: Any = None  # the stream of the last copy
        self.sends = 0

    def _empty(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """A host buffer of at least ``n`` elements, a power of two."""
        return torch.empty(1 << max(10, (n - 1).bit_length()), dtype=dtype,
                           pin_memory=self.pinned)

    def pack(self, parts) -> Tuple[int, list]:
        """Write ``parts``, each ``(array, rows, fill)``, into the host
        buffer: the array's rows, then ``fill`` up to ``rows``. Returns
        (bytes used, each part's (offset, bytes, numpy type, shape))."""
        layout, n = [], 0
        for a, rows, _fill in parts:
            shape = (rows,) + a.shape[1:]
            size = rows * a.itemsize * (a.shape[1] if a.ndim > 1 else 1)
            layout.append((n, size, a.dtype, shape))
            n += (size + 15) & ~15
        if self.sent is not None:
            self.sent.synchronize()
        if self.host is None or self.host.numel() < n:
            self.host = self._empty(n, torch.int8)
            self.host_np = self.host.numpy()
        raw = self.host_np
        for (a, rows, fill), (o, size, dt, shape) in zip(parts, layout):
            view = raw[o : o + size].view(dt).reshape(shape)
            view[: len(a)] = a
            if rows > len(a):
                view[len(a):] = fill
        return n, layout

    def upload(self, n: int, layout) -> List[torch.Tensor]:
        """The packed buffer on the device, in one copy: a view per part."""
        buf = self.host[:n]
        if self.pinned:
            self.stream = torch.cuda.current_stream(self.device)
            buf = buf.to(self.device, non_blocking=True)
            if self.sent is None:
                self.sent = torch.cuda.Event()
            self.sent.record(self.stream)
        self.sends += 1
        ends = [o for o, _size, _dt, _shape in layout[1:]] + [n]
        sizes = []  # each part, then the padding to the next 16-byte boundary
        for (o, size, _dt, _shape), end in zip(layout, ends):
            sizes += (size, end - o - size)
        views = []
        for v, (_o, _size, dt, shape) in zip(buf.split_with_sizes(sizes)[::2], layout):
            if dt.char != "b":
                v = v.view(self._TYPES[dt.char])
            views.append(v.view(shape) if len(shape) > 1 else v)
        return views

    def send(self, parts) -> List[torch.Tensor]:
        return self.upload(*self.pack(parts))

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """The contiguous float32 ``t`` on the host, valid until the next
        fetch: on a card copied into the pinned return buffer, then the
        stream of the last send synchronized before the host reads it."""
        if not self.pinned:
            return t.numpy()
        n = t.numel()
        if self.back is None or self.back.numel() < n:
            self.back = self._empty(n, torch.float32)
            self.back_np = self.back.numpy()
        self.back[:n].copy_(t.view(-1), non_blocking=True)
        self.stream.synchronize()
        return self.back_np[:n].reshape(t.shape)


# ---------------------------------------------------------------------------
# tier manager: residency shared between the engine thread and the prefetcher
# ---------------------------------------------------------------------------


class TierManager:
    """Residency state for one index generation: which clusters are hot
    (payload on the card, within the budget), which are host-cold, which are
    frozen in the spill store. Shared by the engine thread (scoring,
    promotion decisions) and the prefetch worker (staging): every field is
    guarded by ``_cv``'s lock."""

    def __init__(
        self,
        dim: int,
        generation: int,
        *,
        budget_bytes: int = 0,
        device: Any = None,
        spill_store: Any = None,
        spill_prefix: str = "ivf-spill",
        quant: str = "off",
    ):
        self.dim = dim
        self.generation = generation
        self.budget_bytes = budget_bytes
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.quant = quant
        self._cv = threading.Condition()
        self.pages: Dict[int, Optional[_ClusterPages]] = {}
        self.hot: Dict[int, Any] = {}  # cid -> _Mirror (True on the CPU)
        # bytes counted in per hot cid: demotion subtracts exactly what
        # promotion added, not the block's current (possibly grown) size
        self._hot_nbytes: Dict[int, int] = {}
        self.hot_bytes = 0
        self.spilled: Dict[int, str] = {}  # cid -> object key
        self.staging: set = set()
        self.spill_store = spill_store
        self.spill_prefix = spill_prefix
        self._stream: Any = None  # the card copies of promotions

    # -- residency reads ------------------------------------------------------

    def residency(self, cid: int) -> str:
        with self._cv:
            if cid in self.hot:
                return "hot"
            if self.pages.get(cid) is not None:
                return "cold"
            if cid in self.spilled:
                return "spilled"
            return "absent"

    def counts(self) -> Dict[str, int]:
        with self._cv:
            hot = len(self.hot)
            spilled = sum(
                1 for c, p in self.pages.items() if p is None and c in self.spilled
            )
            cold = sum(1 for c, p in self.pages.items() if p is not None) - hot
            return {"hot": hot, "cold": max(0, cold), "spilled": spilled}

    def occupancy(self) -> float:
        with self._cv:
            if self.budget_bytes <= 0:
                return 1.0 if self.hot else 0.0
            return self.hot_bytes / self.budget_bytes

    # -- engine-side installs -------------------------------------------------

    def install(self, cid: int, block: _ClusterPages) -> None:
        """(Re)install a cluster's host block: any card mirror drops and the
        spill entry clears (the blob stays for rebuild snapshots; the
        generation swap's prefix sweep collects it)."""
        with self._cv:
            self.pages[cid] = block
            self._demote_locked(cid)
            self.spilled.pop(cid, None)
            self._cv.notify_all()

    def drop(self, cid: int) -> None:
        with self._cv:
            self.pages.pop(cid, None)
            self._demote_locked(cid)
            self.spilled.pop(cid, None)

    # -- hot tier -------------------------------------------------------------

    def _device_mirror(self, block: _ClusterPages) -> Any:
        """The block's payload on the card, copied on this manager's own
        stream (a promotion runs on the prefetch thread: its copies must not
        queue behind, or hold up, the scoring stream). On the CPU residency
        is bookkeeping only."""
        if self.device.type == "cpu":
            return True
        arrays = block.payload()
        with self._cv:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            stream = self._stream
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            tensors = _to_device(arrays, self.device)
            event = torch.cuda.Event()
            event.record(stream)
        return _Mirror(tensors, event, block.n)

    def promote(self, cid: int) -> bool:
        """Stage ``cid`` hot (called by the prefetcher, or inline). Returns
        False when the block is absent (still frozen), already hot, larger
        than the whole budget, or churned while it was staged."""
        with self._cv:
            block = self.pages.get(cid)
            if block is None or cid in self.hot:
                return False
            nbytes = block.nbytes
            mutations = block.mutations
            if 0 < self.budget_bytes < nbytes:
                # a block bigger than the whole budget can never fit: it
                # serves from the cold tier, so hot_bytes <= budget holds
                return False
            self.staging.add(cid)
        try:
            mirror = self._device_mirror(block)
        finally:
            # the staging slot is released on every path
            with self._cv:
                self.staging.discard(cid)
        evicted: List[Any] = []
        with self._cv:
            if self.pages.get(cid) is not block or block.mutations != mutations:
                # churn replaced or mutated the block mid-stage: a mirror of
                # the pre-churn view never installs
                return False
            self.hot[cid] = mirror
            self._hot_nbytes[cid] = nbytes
            self.hot_bytes += nbytes
            if self.budget_bytes > 0:
                evicted = self._evict_over_budget_locked(keep=cid)
            self._cv.notify_all()
        if evicted:
            telemetry.stage_add("index.demotions", float(len(evicted)))
        return True

    def _demote_locked(self, cid: int) -> None:
        if cid in self.hot:
            del self.hot[cid]
            self.hot_bytes -= self._hot_nbytes.pop(cid, 0)
            self.hot_bytes = max(0, self.hot_bytes)

    def _evict_over_budget_locked(self, keep: int) -> List[int]:
        """Evict hot mirrors (never ``keep``) until within budget, in
        insertion order; the caller holds the lock."""
        evicted: List[int] = []
        while self.hot_bytes > self.budget_bytes and len(self.hot) > 1:
            victim = next((c for c in self.hot if c != keep), None)
            if victim is None:
                break
            self._demote_locked(victim)
            evicted.append(victim)
        return evicted

    # -- frozen spill tier ----------------------------------------------------

    def spill(self, cid: int) -> bool:
        """Freeze a cold, churn-free, compact cluster into the object store
        and drop its host block. Engine thread only."""
        if self.spill_store is None:
            return False
        with self._cv:
            block = self.pages.get(cid)
            if block is None or cid in self.hot or cid in self.staging:
                return False
            if block.n != block.n_live:
                # the blob stores live rows compacted: positions would shift
                return False
        key = f"{self.spill_prefix}/gen{self.generation}/cluster{cid}"
        self.spill_store.put(key, block.to_blob())
        with self._cv:
            if self.pages.get(cid) is not block:
                return False  # churned while serializing: blob is stale
            self.pages[cid] = None
            self.spilled[cid] = key
        return True

    def unspill(self, cid: int) -> Optional[_ClusterPages]:
        """Load a frozen cluster back to the cold tier. Returns the block, or
        None when a racing stage is loading it."""
        with self._cv:
            block = self.pages.get(cid)
            if block is not None:
                return block
            key = self.spilled.get(cid)
            if key is None or cid in self.staging:
                return None
            self.staging.add(cid)
        blob = None
        try:
            if self.spill_store is not None:
                blob = self.spill_store.get(key)
        finally:
            with self._cv:
                self.staging.discard(cid)
        if blob is None:
            raise TieredIndexError(
                f"spill tier lost cluster {cid} (key {key!r}): the frozen "
                "object store no longer serves it"
            )
        loaded = _ClusterPages.from_blob(self.dim, blob, quant=self.quant == "int8")
        with self._cv:
            if self.pages.get(cid) is None and self.spilled.get(cid) == key:
                self.pages[cid] = loaded
                self.spilled.pop(cid, None)
                self._cv.notify_all()
                return loaded
            return self.pages.get(cid)

    def wait_loaded(self, cid: int, timeout: float) -> Optional[_ClusterPages]:
        """Block (bounded) until a staged cluster's block lands."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                block = self.pages.get(cid)
                if block is not None:
                    return block
                if cid not in self.staging and cid not in self.spilled:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(timeout=min(0.25, remaining))


# ---------------------------------------------------------------------------
# async prefetcher
# ---------------------------------------------------------------------------


class Prefetcher:
    """One background worker staging cluster pages ahead of the scorer:
    unspills frozen clusters and promotes probed ones hot. Lazily spawned,
    daemon, joined by :meth:`close`; the queue is bounded so a probe storm
    degrades to the scorer's synchronous staging."""

    _IDLE_POLL_S = 0.25

    def __init__(self) -> None:
        self._queue: "queue.Queue[tuple]" = queue.Queue(maxsize=4096)
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._stop = threading.Event()

    def request(self, manager: TierManager, cids: List[int], *, promote: bool) -> None:
        self._ensure_thread()
        for cid in cids:
            try:
                self._queue.put_nowait((manager, cid, promote))
            except queue.Full:
                break  # the scorer stages synchronously
        telemetry.stage_add("index.prefetch_requests", float(len(cids)))

    def _ensure_thread(self) -> None:
        with self._mu:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="pathway:ivf-prefetch", daemon=True
                )
                self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                manager, cid, promote = self._queue.get(timeout=self._IDLE_POLL_S)
            except queue.Empty:
                continue
            try:
                if manager.residency(cid) == "spilled":
                    manager.unspill(cid)
                    telemetry.stage_add("index.unspills")
                if promote and manager.promote(cid):
                    telemetry.stage_add("index.promotions")
                telemetry.stage_add("index.prefetch_staged")
            except TieredIndexError:
                # the scorer's synchronous path surfaces the typed failure
                telemetry.stage_add("index.prefetch_errors")

    def close(self) -> None:
        with self._mu:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            self._stop.set()
            thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# background rebuild and centroid training
# ---------------------------------------------------------------------------


class _RebuildResult:
    __slots__ = ("generation", "centroids", "pages", "where", "trained_sizes", "error")

    def __init__(self, generation: int):
        self.generation = generation
        self.centroids: Optional[np.ndarray] = None
        self.pages: Dict[int, _ClusterPages] = {}
        self.where: Dict[int, int] = {}
        self.trained_sizes: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


def _two_means(vecs: np.ndarray, iters: int = 6) -> np.ndarray:
    """Host 2-means over one cluster's members; returns a bool mask of the
    second group (the split path)."""
    c0, c1 = vecs[0], vecs[len(vecs) // 2]
    g1 = np.zeros(len(vecs), dtype=bool)
    for _ in range(iters):
        d0 = np.sum((vecs - c0) ** 2, axis=1)
        d1 = np.sum((vecs - c1) ** 2, axis=1)
        g1 = d1 < d0
        if g1.all() or (~g1).all():
            break
        c0 = vecs[~g1].mean(axis=0)
        c1 = vecs[g1].mean(axis=0)
    return g1


_TRAIN_SAMPLE_PER_CLUSTER = 32


def _train_centroids(
    sample: np.ndarray, n_clusters: int, train_iters: int, seed: int = 0,
    device: Any = "cpu",
) -> np.ndarray:
    """k-means over a bounded sample through the port's ``_kmeans_kernel``
    on ``device``; returns writable host (C, dim) f32 centroids."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(len(sample), size=n_clusters, replace=len(sample) < n_clusters)
    init = torch.from_numpy(np.ascontiguousarray(sample[seeds], dtype=np.float32)).to(dev)
    pad = (-len(sample)) % _KMEANS_CHUNK
    vecs = sample
    if pad:
        vecs = np.concatenate([sample, np.zeros((pad, sample.shape[1]), np.float32)])
    valid = torch.from_numpy(np.arange(len(vecs)) < len(sample)).to(dev)
    cents = _kmeans_kernel(
        torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(dev),
        valid, init, train_iters,
    )
    return np.array(cents.cpu().numpy(), dtype=np.float32)


def _assign_rows_np(rows: np.ndarray, centroids: np.ndarray, device: Any = "cpu") -> np.ndarray:
    """Top-2 centroid assignment (``_assign2_kernel``), chunked, each chunk
    padded to a pow2 row bucket (floor 256) as the reference pads it."""
    if not len(rows):
        return np.zeros((0, 2), dtype=np.int32)
    dev = torch.device(device)
    cents = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32)).to(dev)
    chunk = max(1024, (1 << 28) // max(len(centroids), rows.shape[1], 1))
    parts = []
    for start in range(0, len(rows), chunk):
        block = rows[start : start + chunk]
        n = len(block)
        bucket = next_pow2(max(256, n))
        if bucket != n:
            block = np.concatenate(
                [block, np.zeros((bucket - n, block.shape[1]), block.dtype)]
            )
        got = _assign2_kernel(torch.from_numpy(np.ascontiguousarray(block)).to(dev), cents)
        parts.append(got.cpu().numpy()[:n])
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# the tiered store
# ---------------------------------------------------------------------------


class TieredIvfKnnStore:
    """Keyed IVF-Flat store with tiered page residency and churn-native
    maintenance. API-compatible with ``knn_ivf.IvfKnnStore`` where the
    engine touches it (``add`` / ``add_many`` / ``remove`` / ``search_batch``
    / ``key_of`` / ``slot_of`` / ``export_rows``). ``device``: the card
    (``None``) or ``"cpu"``, where the block scorers take their plain
    versions."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2sq",
        initial_capacity: int = 1024,  # accepted for API parity; blocks size themselves
        n_clusters: int = 64,
        n_probe: int = 8,
        train_iters: int = 8,
        device: Any = None,
        hbm_budget_bytes: "int | None" = None,
        spill_store: Any = None,
        prefetch: "bool | None" = None,
        quant: "str | None" = None,
    ):
        if metric not in ("l2sq", "cos", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.device = resolve_device(device)
        # "off" | "int8", resolved once: a later env flip needs a new store
        self._quant = quant_mode(quant)
        self._qblocks = self._quant == "int8"
        if self.device.type == "cuda":  # before ingest, not at the first retrieve
            check_row_width(dim, torch.int8 if self._qblocks else torch.float32)
        # the int8 coarse-probe mirror of the centroids (host arrays and
        # their checked table on the device), dropped at every site that
        # moves self._cents (train / split / maintain / swap)
        self._qcents: "Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]" = None
        self._qcents_dev: "Optional[knn_quant.ProbeTable]" = None
        # one search at a time: a search mutates the EWMA, the stats, the
        # tiers and the query staging buffers
        self._search_lock = threading.Lock()
        self._stage = _QueryStage(self.device)
        self.n_clusters = max(2, n_clusters)
        self.n_probe = min(n_probe, self.n_clusters)
        self._n_clusters_base = self.n_clusters
        self.train_iters = train_iters
        self.slot_of: Dict[Any, int] = {}
        self.key_of: Dict[int, Any] = {}
        self._next_slot = 0
        # staged adds keyed by slot: removing a just-staged row is O(1)
        self._staged: Dict[int, np.ndarray] = {}
        self._staged_removals: List[int] = []
        # pre-train holding pen: rows wait here until the first training pass
        self._untrained_slots: List[int] = []
        self._untrained_vecs: List[np.ndarray] = []
        self.generation = 0
        self._cents: Optional[np.ndarray] = None  # (C, dim) f32, host
        # slot -> (cid << 32) | pos
        self._where: Dict[int, int] = {}
        self._trained_sizes = np.zeros(0, dtype=np.int64)
        self._drift = np.zeros(0, dtype=np.int64)
        self._ewma = np.zeros(0, dtype=np.float64)
        self._churn_since_train = 0
        self._trained_total = 0
        self._batches = 0  # search batches served (spill settling guard)
        self._rescore_hist = None  # cached handle; histogram() locks a registry
        if hbm_budget_bytes is None:
            hbm_budget_bytes = _hbm_budget_env()
        self._budget_bytes = int(hbm_budget_bytes)
        if spill_store is None:
            spill_dir = os.environ.get("PATHWAY_IVF_SPILL_DIR")
            if spill_dir:
                spill_store = DirSpillStore(spill_dir)
        self.tiers = TierManager(
            dim, 0, budget_bytes=self._budget_bytes, device=self.device,
            spill_store=spill_store, quant=self._quant,
        )
        self._prefetch_on = _prefetch_enabled() if prefetch is None else bool(prefetch)
        self._prefetcher = Prefetcher()
        # background rebuild state (shared with the rebuild worker)
        self._mu = threading.Lock()
        self._pending: Optional[_RebuildResult] = None
        self._rebuild_thread: Optional[threading.Thread] = None
        self._rebuild_dirty: Optional[set] = None  # slots churned post-snapshot
        self.stats: Dict[str, float] = {
            "rebuilds": 0, "swaps": 0, "swaps_torn": 0, "splits": 0,
            "merges": 0, "compactions": 0, "spills": 0, "max_pause_s": 0.0,
            "prefetch_stall_s": 0.0, "probe_hot": 0, "probe_cold": 0,
            "probe_spilled": 0, "quant_recalibrations": 0, "quant_chaos_aborts": 0,
            "staged_blocks": 0, "staged_bytes": 0,
        }

    # -- ingest ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.slot_of)

    def add(self, key: Any, vector: Any) -> None:
        vector = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vector.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: {vector.shape[0]} != {self.dim}")
        if key in self.slot_of:
            self.remove(key)
        slot = self._next_slot
        self._next_slot += 1
        self.slot_of[key] = slot
        self.key_of[slot] = key
        self._staged[slot] = vector

    def add_many(self, keys: List[Any], vectors: Any) -> None:
        vectors = np.asarray(vectors, dtype=np.float32).reshape(len(keys), self.dim)
        last = {k: i for i, k in enumerate(keys)}  # intra-batch dedup: last wins
        if len(last) != len(keys):
            keep = sorted(last.values())
            keys = [keys[i] for i in keep]
            vectors = vectors[keep]
        for k in [k for k in keys if k in self.slot_of]:
            self.remove(k)
        first = self._next_slot
        slots = list(range(first, first + len(keys)))
        self._next_slot += len(keys)
        self.slot_of.update(zip(keys, slots))
        self.key_of.update(zip(slots, keys))
        self._staged.update(zip(slots, vectors))

    def remove(self, key: Any) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self.key_of.pop(slot, None)
        if self._staged.pop(slot, None) is not None:
            return
        self._staged_removals.append(slot)

    # -- churn application (the flush path: no global rebuild) ----------------

    def _flush(self) -> None:
        if self._staged:
            slots = np.fromiter(self._staged.keys(), dtype=np.int64)
            vecs = np.stack(list(self._staged.values())).astype(np.float32)
            self._staged = {}
            if self._cents is None:
                self._untrained_slots.extend(slots.tolist())
                self._untrained_vecs.extend(vecs)
            else:
                self._place_rows(slots, vecs)
        if self._staged_removals:
            removals = self._staged_removals
            self._staged_removals = []
            for slot in removals:
                self._remove_slot(slot)

    def _place_rows(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        """Assign a churn batch to its clusters and append per cluster: only
        the touched clusters' blocks re-stage."""
        top2 = _assign_rows_np(vecs, self._cents, self.device)
        norms = np.sum(vecs * vecs, axis=1)
        order = np.argsort(top2[:, 0], kind="stable")
        cids = top2[order, 0]
        uniq, first_idx = np.unique(cids, return_index=True)
        bounds = np.append(first_idx, len(cids))
        dirty = self._rebuild_dirty
        for g, cid in enumerate(uniq):
            sel = order[bounds[g] : bounds[g + 1]]
            cid = int(cid)
            block = self._block(cid, create=True)
            first = block.append(slots[sel], vecs[sel], norms[sel])
            base = cid << 32
            self._where.update(zip(slots[sel].tolist(), range(base | first, base | (first + len(sel)))))
            self.tiers.install(cid, block)
            if cid < len(self._drift):
                self._drift[cid] += len(sel)
        self._churn_since_train += len(slots)
        if dirty is not None:
            dirty.update(int(s) for s in slots)

    def _remove_slot(self, slot: int) -> None:
        loc = self._where.pop(slot, None)
        if loc is None:
            # still in the pre-train pen
            if slot in self._untrained_slots:
                i = self._untrained_slots.index(slot)
                del self._untrained_slots[i]
                del self._untrained_vecs[i]
            return
        cid, pos = loc >> 32, loc & 0xFFFFFFFF
        block = self._block(cid, create=False)
        if block is not None:
            block.invalidate(pos)
            self.tiers.install(cid, block)  # stale mirrors drop
        if cid < len(self._drift):
            self._drift[cid] += 1
        self._churn_since_train += 1
        if self._rebuild_dirty is not None:
            self._rebuild_dirty.add(slot)

    def _block(self, cid: int, *, create: bool) -> Optional[_ClusterPages]:
        """The cluster's host block, unspilling synchronously when frozen
        (churn unfreezes: the spill tier only holds idle clusters)."""
        with self.tiers._cv:
            block = self.tiers.pages.get(cid)
            frozen = block is None and cid in self.tiers.spilled
        if block is None and frozen:
            block = self.tiers.unspill(cid)
            if block is None:
                # the prefetcher is mid-stage on this cluster: wait for its
                # block rather than installing an empty one over it
                block = self.tiers.wait_loaded(cid, timeout=30.0)
        if block is None and create:
            with self.tiers._cv:
                block = self.tiers.pages.get(cid)
                if block is None:
                    block = _ClusterPages(self.dim, quant=self._qblocks)
                    self.tiers.pages[cid] = block
                    self.tiers._cv.notify_all()
        return block

    # -- training / maintenance ----------------------------------------------

    def set_centroids(self, centroids: Any) -> None:
        """Place the staged corpus on the given (C, dim) initial centroids
        instead of training them: the tail of the first train (place, split
        oversized clusters). Parity tests hand the reference's trained
        centroids in here."""
        self._flush()
        if self._cents is not None:
            raise TieredIndexError("the store is trained already")
        self._initial_train(np.array(centroids, dtype=np.float32))

    def _initial_train(self, centroids: "np.ndarray | None" = None) -> None:
        if not self._untrained_slots:
            return
        slots = np.asarray(self._untrained_slots, dtype=np.int64)
        vecs = np.stack(self._untrained_vecs).astype(np.float32)
        self._untrained_slots, self._untrained_vecs = [], []
        self.n_clusters = self._n_clusters_base
        if centroids is None:
            rng = np.random.default_rng(0)
            cap = self.n_clusters * _TRAIN_SAMPLE_PER_CLUSTER
            sample = vecs if len(vecs) <= cap else vecs[rng.choice(len(vecs), cap, replace=False)]
            centroids = _train_centroids(sample, self.n_clusters, self.train_iters,
                                         device=self.device)
        self._cents = centroids
        self.n_clusters = len(centroids)
        self._drop_qcents()
        self._grow_cluster_arrays(self.n_clusters)
        self._place_rows(slots, vecs)
        # splits bound the bucket width the probes pay for
        self._split_oversized_clusters()
        self._trained_total = len(slots)
        self._trained_sizes = np.array(
            [self._live_count(c) for c in range(self.n_clusters)], dtype=np.int64
        )
        self._drift = np.zeros(self.n_clusters, dtype=np.int64)
        self._churn_since_train = 0

    def _drop_qcents(self) -> None:
        self._qcents = None
        self._qcents_dev = None

    def _grow_cluster_arrays(self, n: int) -> None:
        if len(self._drift) < n:
            extra = n - len(self._drift)
            self._drift = np.concatenate([self._drift, np.zeros(extra, np.int64)])
            self._trained_sizes = np.concatenate(
                [self._trained_sizes, np.zeros(extra, np.int64)]
            )
            self._ewma = np.concatenate([self._ewma, np.zeros(extra, np.float64)])

    def _live_count(self, cid: int) -> int:
        with self.tiers._cv:
            block = self.tiers.pages.get(cid)
        return block.n_live if block is not None else 0

    @staticmethod
    def _cap_for(n_live: int, n_clusters: int) -> int:
        mean = max(1, n_live // max(n_clusters, 1))
        cap = 8
        while cap < (3 * mean + 1) // 2:
            cap *= 2
        return cap

    def _split_oversized_clusters(self) -> None:
        cap = self._cap_for(len(self.slot_of), self.n_clusters)
        limit = 2 * self._n_clusters_base
        for cid in range(self.n_clusters):
            if self.n_clusters >= limit:
                break
            block = self._block(cid, create=False)
            if block is None or block.n_live <= cap:
                continue
            self._split_cluster(cid)

    def _split_cluster(self, cid: int) -> None:
        """2-means split: half the members move to a new cluster; only the
        moved rows' locators rewrite."""
        block = self._block(cid, create=False)
        if block is None or block.n_live < 2 * PAGE // 8:
            return
        slots, vecs, norms = block.live_rows()
        g1 = _two_means(vecs)
        if not g1.any() or g1.all():
            return
        new_cid = self.n_clusters
        self.n_clusters += 1
        self._grow_cluster_arrays(self.n_clusters)
        keep_block = _ClusterPages(self.dim, cap=int((~g1).sum()), quant=self._qblocks)
        keep_block.append(slots[~g1], vecs[~g1], norms[~g1])
        new_block = _ClusterPages(self.dim, cap=int(g1.sum()), quant=self._qblocks)
        new_block.append(slots[g1], vecs[g1], norms[g1])
        for j, s in enumerate(slots[~g1]):
            self._where[int(s)] = (cid << 32) | j
        for j, s in enumerate(slots[g1]):
            self._where[int(s)] = (new_cid << 32) | j
        cents = np.asarray(self._cents)
        new_cents = np.concatenate([cents, vecs[g1].mean(axis=0)[None, :]])
        new_cents[cid] = vecs[~g1].mean(axis=0)
        self._cents = new_cents
        self._drop_qcents()
        self.tiers.install(cid, keep_block)
        self.tiers.install(new_cid, new_block)
        self._trained_sizes[cid] = keep_block.n_live
        self._trained_sizes[new_cid] = new_block.n_live
        self._drift[cid] = 0
        self._drift[new_cid] = 0
        self.stats["splits"] += 1
        telemetry.stage_add("index.splits")

    def _maintain_cluster(self, cid: int) -> None:
        """Per-cluster drift response: compact, recenter, re-assign strays,
        split or merge; never a global pass."""
        block = self._block(cid, create=False)
        if block is None:
            return
        # every branch may move self._cents rows in place
        self._drop_qcents()
        if block.n_live < block.n // 2 and block.n >= PAGE:
            self._compact_cluster(cid, block)
            block = self._block(cid, create=False)
            if block is None:
                return
        slots, vecs, norms = block.live_rows()
        n_live = len(slots)
        if n_live == 0:
            self._cents[cid] = _DEAD_CENTROID  # never probed until a row lands again
            self._drift[cid] = 0
            self._trained_sizes[cid] = 0
            return
        self._cents[cid] = vecs.mean(axis=0)
        # re-assign: members now nearer another centroid move there
        top2 = _assign_rows_np(vecs, self._cents, self.device)
        stray = top2[:, 0] != cid
        small = n_live < max(4, self._cap_for(len(self.slot_of), self.n_clusters) // 16)
        if small and self.n_clusters > 2:
            # merge: drain the cluster into each row's next-best home
            dest = np.where(top2[:, 0] == cid, top2[:, 1], top2[:, 0])
            self._move_rows(cid, slots, vecs, norms, dest)
            self._cents[cid] = _DEAD_CENTROID
            self.stats["merges"] += 1
            telemetry.stage_add("index.merges")
        elif stray.any() and stray.sum() < n_live:
            self._move_rows(
                cid, slots[stray], vecs[stray], norms[stray], top2[stray, 0]
            )
        block = self._block(cid, create=False)
        if block is not None and block.n_live > self._cap_for(
            len(self.slot_of), self.n_clusters
        ):
            self._split_cluster(cid)
        self._drift[cid] = 0
        self._trained_sizes[cid] = self._live_count(cid)
        if self._qblocks:
            block = self._block(cid, create=False)
            if block is not None:
                self._recalibrate_quant(cid, block)

    def _recalibrate_quant(self, cid: int, block: _ClusterPages) -> None:
        """Per-page scale recalibration on the maintenance path: recompute
        each page's scale over its live rows only and re-derive the codes,
        off to the side, then install them by reference swaps (the old
        scales serve until the swap)."""
        if not block.quant or block.n == 0:
            return
        cap = len(block.slots)
        n_pages = max(1, cap // PAGE)
        new_qvecs = np.zeros((cap, self.dim), dtype=np.int8)
        new_qscale = np.ones(n_pages, dtype=np.float32)
        new_qzero = np.zeros(n_pages, dtype=np.float32)
        for p in range(n_pages):
            lo, hi = p * PAGE, min((p + 1) * PAGE, cap)
            live = block.valid[lo:hi]
            rows = block.vecs[lo:hi]
            s = knn_quant.page_scale(rows[live] if live.any() else rows)
            new_qscale[p] = np.float32(s)
            # dead rows quantize at the live scale too (they may clip): the
            # validity mask hides them
            new_qvecs[lo:hi] = knn_quant.quantize_rows(rows, s)
        chaos = get_chaos()
        if chaos is not None and chaos.index_fault("quant", get_pathway_config().process_id):
            # an injected kill in the middle of the recalibration: the new
            # sidecars are dropped before anything re-points, the old scales
            # serve on (the fp32 rescore never read them)
            self.stats["quant_chaos_aborts"] += 1
            telemetry.stage_add("index.quant.chaos_aborts")
            _record_event("chaos_quant_kill", cluster=cid, generation=self.generation)
            return
        block.qvecs, block.qscale, block.qzero = new_qvecs, new_qscale, new_qzero
        block._drop_quant_caches()
        block.mutations += 1  # a mirror staged off the old codes must not install
        self.tiers.install(cid, block)  # hot mirrors of the old codes drop
        self.stats["quant_recalibrations"] += 1
        telemetry.stage_add("index.quant.recalibrations")
        _record_event("quant_swap", cluster=cid, generation=self.generation)

    def _move_rows(
        self,
        from_cid: int,
        slots: np.ndarray,
        vecs: np.ndarray,
        norms: np.ndarray,
        dest: np.ndarray,
    ) -> None:
        src = self._block(from_cid, create=False)
        for s in slots:
            loc = self._where.get(int(s))
            if loc is not None and src is not None and (loc >> 32) == from_cid:
                src.invalidate(loc & 0xFFFFFFFF)
        order = np.argsort(dest, kind="stable")
        uniq, first_idx = np.unique(dest[order], return_index=True)
        bounds = np.append(first_idx, len(order))
        for g, cid in enumerate(uniq):
            cid = int(cid)
            if cid == from_cid:
                continue
            sel = order[bounds[g] : bounds[g + 1]]
            target = self._block(cid, create=True)
            first = target.append(slots[sel], vecs[sel], norms[sel])
            base = cid << 32
            for j, row in enumerate(sel):
                self._where[int(slots[row])] = base | (first + j)
            self.tiers.install(cid, target)
        if src is not None:
            self.tiers.install(from_cid, src)

    def _compact_cluster(self, cid: int, block: _ClusterPages) -> None:
        slots, vecs, norms = block.live_rows()
        fresh = _ClusterPages(self.dim, cap=max(PAGE, len(slots)), quant=self._qblocks)
        if len(slots):
            fresh.append(slots, vecs, norms)
        base = cid << 32
        for j, s in enumerate(slots):
            self._where[int(s)] = base | j
        self.tiers.install(cid, fresh)
        self.stats["compactions"] += 1
        telemetry.stage_add("index.compactions")

    def _maintain(self) -> None:
        """The commit-boundary maintenance pass: bounded per-cluster work for
        drifted clusters; schedule the background rebuild."""
        if self._cents is None:
            return
        if self._rebuild_inflight():
            # the pending generation supersedes any per-cluster fix
            return
        t0 = time.perf_counter()
        did = 0
        threshold = _cluster_drift_threshold()
        drifted = np.nonzero(
            self._drift > np.maximum(8, threshold * np.maximum(self._trained_sizes, 1))
        )[0]
        for cid in drifted[:64]:  # bound one pass; the rest drift into the next
            self._maintain_cluster(int(cid))
            did += 1
        if did:
            telemetry.stage_add("index.maintain_clusters", float(did))
        if (
            self._churn_since_train
            >= _rebuild_drift_threshold() * max(self._trained_total, 1)
            and not self._rebuild_inflight()
        ):
            self._schedule_rebuild()
        self._maybe_spill()
        pause = time.perf_counter() - t0
        if did or pause > 1e-4:
            telemetry.stage_add("index.maintain_s", pause)
            self.stats["max_pause_s"] = max(self.stats["max_pause_s"], pause)

    def _maybe_spill(self) -> None:
        if self.tiers.spill_store is None or self._cents is None:
            return
        if self._batches < 4:
            return  # the EWMA has no history yet: freezing now thrashes the probes
        eps = _spill_ewma_threshold()
        frozen = 0
        for cid in range(min(self.n_clusters, len(self._ewma))):
            if frozen >= 16:
                break
            if self._ewma[cid] >= eps or self._drift[cid] > 0:
                continue
            if self.tiers.residency(cid) != "cold":
                continue
            block = self._block(int(cid), create=False)
            if block is not None and block.n != block.n_live:
                # compact first: positions must survive the spill round trip
                self._compact_cluster(int(cid), block)
            if self.tiers.spill(int(cid)):
                frozen += 1
        if frozen:
            self.stats["spills"] += frozen
            telemetry.stage_add("index.spills", float(frozen))

    # -- background rebuild ----------------------------------------------------

    def _rebuild_inflight(self) -> bool:
        with self._mu:
            return self._rebuild_thread is not None or self._pending is not None

    def _schedule_rebuild(self) -> None:
        """Snapshot the corpus (write-once rows + copied validity masks) and
        train the next generation off-thread; live churn keeps landing in the
        current generation and in the dirty-set the swap reconciles."""
        # (vecs, norms, slots, valid, n) per resident cluster; frozen clusters
        # enter as ("spill", key) and the worker loads them
        snapshot: List[tuple] = []
        with self.tiers._cv:
            pages = dict(self.tiers.pages)
            spilled = dict(self.tiers.spilled)
        for cid in range(self.n_clusters):
            block = pages.get(cid)
            if block is None:
                key = spilled.get(cid)
                if key is not None:
                    snapshot.append(("spill", key))
                continue
            if block.n == 0:
                continue
            snapshot.append(
                (block.vecs, block.norms, block.slots, block.valid[: block.n].copy(), block.n)
            )
        if not snapshot:
            return
        chaos = get_chaos()
        rank = get_pathway_config().process_id
        if chaos is not None:
            chaos.begin_rebuild_attempt()
        generation = self.generation + 1
        self.stats["rebuilds"] += 1
        telemetry.stage_add("index.rebuilds")
        _record_event(
            "index_rebuild", generation=generation, clusters=len(snapshot),
            rows=len(self.slot_of),
        )
        self._rebuild_dirty = set()
        thread = threading.Thread(
            target=self._rebuild_worker,
            args=(generation, snapshot, chaos, rank),
            name="pathway:ivf-rebuild",
            daemon=True,
        )
        with self._mu:
            self._rebuild_thread = thread
        thread.start()

    def _rebuild_worker(
        self, generation: int, snapshot: List[tuple], chaos: Any, rank: int
    ) -> None:
        result = _RebuildResult(generation)
        try:
            if chaos is not None:
                # a scheduled ``rebuild_kill`` takes the process down while
                # the new generation is being built
                chaos.maybe_rebuild_kill(rank, generation=generation)
            spill_store = self.tiers.spill_store
            resolved: List[tuple] = []
            for entry in snapshot:
                if not isinstance(entry[0], str):
                    resolved.append(entry)
                    continue
                blob = spill_store.get(entry[1]) if spill_store is not None else None
                if blob is None:
                    raise TieredIndexError(
                        f"rebuild snapshot lost frozen cluster blob {entry[1]!r}"
                    )
                block = _ClusterPages.from_blob(self.dim, blob, quant=self._qblocks)
                resolved.append(
                    (block.vecs, block.norms, block.slots,
                     block.valid[: block.n].copy(), block.n)
                )
            snapshot = resolved
            rng = np.random.default_rng(generation)
            n_clusters = self._n_clusters_base
            cap = n_clusters * _TRAIN_SAMPLE_PER_CLUSTER
            total = sum(int(v.sum()) for _, _, _, v, _ in snapshot)
            # proportional per-cluster sample, streamed block by block
            parts = []
            for vecs, _norms, _slots, valid, n in snapshot:
                live = vecs[:n][valid]
                take = min(len(live), max(1, int(round(cap * len(live) / max(total, 1)))))
                if take >= len(live):
                    parts.append(live)
                else:
                    parts.append(live[rng.choice(len(live), take, replace=False)])
            sample = np.concatenate(parts) if parts else np.zeros((0, self.dim), np.float32)
            cents = _train_centroids(sample, n_clusters, self.train_iters, seed=generation,
                                     device=self.device)
            members: Dict[int, List[tuple]] = {}
            for vecs, norms, slots, valid, n in snapshot:
                lv = vecs[:n][valid]
                if not len(lv):
                    continue
                top2 = _assign_rows_np(lv, cents, self.device)
                ls, ln = slots[:n][valid], norms[:n][valid]
                for cid in np.unique(top2[:, 0]):
                    sel = top2[:, 0] == cid
                    members.setdefault(int(cid), []).append((ls[sel], lv[sel], ln[sel]))
            pages: Dict[int, _ClusterPages] = {}
            for cid, chunks in members.items():
                slots_c = np.concatenate([c[0] for c in chunks])
                vecs_c = np.concatenate([c[1] for c in chunks])
                norms_c = np.concatenate([c[2] for c in chunks])
                block = _ClusterPages(
                    self.dim, cap=max(PAGE, len(slots_c)), quant=self._qblocks
                )
                block.append(slots_c, vecs_c, norms_c)
                pages[cid] = block
            cents, pages = _rebuild_split_pass(
                cents, pages, self.dim, self._n_clusters_base, quant=self._qblocks
            )
            # locators packed (cid << 32) | pos, as self._where holds them
            where: Dict[int, int] = {}
            trained = np.zeros(len(cents), dtype=np.int64)
            for cid, block in pages.items():
                trained[cid] = block.n_live
                base = cid << 32
                where.update(zip(block.slots[: block.n].tolist(),
                                 range(base, base + block.n)))
            result.centroids = cents
            result.pages = pages
            result.where = where
            result.trained_sizes = trained
        except BaseException as exc:  # shipped to the engine thread, re-raised typed at the swap
            result.error = exc
        with self._mu:
            self._pending = result
            self._rebuild_thread = None

    def _swap_torn(self) -> bool:
        """Whether this swap is abandoned before anything re-points: a chaos
        plan's ``tier_swap_torn`` at the current rebuild attempt."""
        chaos = get_chaos()
        return chaos is not None and chaos.index_fault(
            "tier_swap_torn", get_pathway_config().process_id
        )

    def _maybe_swap(self) -> None:
        """The commit-boundary generation swap: atomic from any reader's view
        (everything re-points in one engine-thread pass; queries run between
        commits). The old generation serves until this commits."""
        with self._mu:
            pending = self._pending
            if pending is None:
                return
            self._pending = None
        dirty = self._rebuild_dirty or set()
        self._rebuild_dirty = None
        if pending.error is not None:
            raise TieredIndexError(
                f"background index rebuild for generation {pending.generation} "
                f"failed: {pending.error!r}"
            ) from pending.error
        if self._swap_torn():
            # the pending generation is discarded before anything re-points:
            # the old generation keeps serving, drift still exceeds the
            # threshold, and the next maintenance pass rebuilds afresh
            self.stats["swaps_torn"] += 1
            telemetry.stage_add("index.swaps_torn")
            _record_event("index_swap", generation=pending.generation, torn=True)
            return
        t0 = time.perf_counter()
        new_tiers = TierManager(
            self.dim, pending.generation, budget_bytes=self._budget_bytes,
            device=self.device, spill_store=self.tiers.spill_store,
            quant=self._quant,
        )
        for cid, block in pending.pages.items():
            new_tiers.pages[cid] = block
        cents = pending.centroids
        where = pending.where
        trained = pending.trained_sizes
        # reconcile churn that landed after the snapshot
        dirty_adds: List[int] = []
        for slot in dirty:
            if slot not in self.key_of:
                # removed post-snapshot: flip it dead in the new generation
                loc = where.pop(slot, None)
                if loc is not None:
                    block = new_tiers.pages.get(loc >> 32)
                    if block is not None:
                        block.invalidate(loc & 0xFFFFFFFF)
                continue
            if slot not in where:
                dirty_adds.append(slot)
        if dirty_adds:
            vecs = np.stack([self._vector_of(s) for s in dirty_adds]).astype(np.float32)
            top2 = _assign_rows_np(vecs, cents, self.device)
            norms = np.sum(vecs * vecs, axis=1)
            for i, slot in enumerate(dirty_adds):
                cid = int(top2[i, 0])
                block = new_tiers.pages.get(cid)
                if block is None:
                    block = _ClusterPages(self.dim, quant=self._qblocks)
                    new_tiers.pages[cid] = block
                pos = block.append(
                    np.asarray([slot]), vecs[i : i + 1], norms[i : i + 1]
                )
                where[slot] = (cid << 32) | pos
        old_tiers = self.tiers
        self._cents = cents
        self._drop_qcents()
        self._where = where
        self.n_clusters = len(cents)
        self.tiers = new_tiers
        self.generation = pending.generation
        self._trained_sizes = trained
        self._drift = np.zeros(len(cents), dtype=np.int64)
        self._ewma = np.zeros(len(cents), dtype=np.float64)
        self._trained_total = len(self.slot_of)
        self._churn_since_train = 0
        # re-arm the spill settling guard: the fresh EWMA is all zeros
        self._batches = 0
        # the old generation is retired: sweep every blob under its prefix
        if old_tiers.spill_store is not None:
            with old_tiers._cv:
                old_tiers.spilled.clear()
            prefix = f"{old_tiers.spill_prefix}/gen{old_tiers.generation}"
            for key in old_tiers.spill_store.list(prefix):
                old_tiers.spill_store.delete(key)
        pause = time.perf_counter() - t0
        self.stats["swaps"] += 1
        self.stats["max_pause_s"] = max(self.stats["max_pause_s"], pause)
        telemetry.stage_add_many({"index.swaps": 1.0, "index.swap_s": pause})
        _record_event(
            "index_swap", generation=self.generation, pause_s=round(pause, 4),
            clusters=self.n_clusters,
        )

    def _vector_of(self, slot: int) -> np.ndarray:
        loc = self._where.get(slot)
        if loc is None:
            raise TieredIndexError(f"slot {slot} has no located vector")
        cid = loc >> 32
        block = self._block(cid, create=False)
        if block is None:
            raise TieredIndexError(f"cluster {cid} pages unavailable for slot {slot}")
        return block.vecs[loc & 0xFFFFFFFF]

    # -- search ---------------------------------------------------------------

    def _quant_cents(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The int8 coarse-probe mirror: per-centroid symmetric codes (a
        centroid is a one-row page) and exact fp32 ``|c|^2``, padded to a
        pow2 centroid count with ``cn = +inf`` rows (affinity -inf, never
        probed)."""
        if self._qcents is None:
            cents = np.asarray(self._cents, dtype=np.float32)
            c_now = len(cents)
            c_pad = next_pow2(max(8, c_now))
            codes = np.zeros((c_pad, self.dim), dtype=np.int8)
            scales = np.ones(c_pad, dtype=np.float32)
            cn = np.full(c_pad, np.inf, dtype=np.float32)
            m = np.max(np.abs(cents), axis=1)
            scales[:c_now] = np.where(m > 0.0, m / 127.0, 1.0)
            codes[:c_now] = np.clip(
                np.rint(cents / scales[:c_now, None]), -127, 127
            ).astype(np.int8)
            cn[:c_now] = np.sum(cents * cents, axis=1)
            self._qcents = (codes, scales, cn)
            self._qcents_dev = None
        return self._qcents

    def _effective_n_probe(self) -> int:
        """Brownout-aware probe count (rung 2 halves ``n_probe``)."""
        from pathway_tpu_torch.engine.brownout import get_brownout

        return max(1, self.n_probe >> get_brownout().nprobe_shift())

    def _prepare_search(self) -> bool:
        self._flush()
        if self._cents is None:
            self._initial_train()
        self._maybe_swap()
        self._maintain()
        # a swap scheduled by this maintain pass is taken at the next commit
        # boundary: queries in between keep the old generation
        return self._cents is not None

    def _touch(self, probed: np.ndarray, counts: np.ndarray, allow_promote: bool) -> None:
        alpha = _ewma_alpha()
        if len(self._ewma) < self.n_clusters:
            self._grow_cluster_arrays(self.n_clusters)
        self._ewma *= 1.0 - alpha
        share = counts / max(counts.sum(), 1)
        self._ewma[probed] += alpha * share * len(probed)
        if not allow_promote:
            return
        to_promote = [
            int(c) for c in probed if self.tiers.residency(int(c)) in ("cold", "spilled")
        ]
        if not to_promote:
            return
        if self._prefetch_on:
            self._prefetcher.request(self.tiers, to_promote, promote=True)
        else:
            for cid in to_promote:
                if self.tiers.residency(cid) == "spilled":
                    self.tiers.unspill(cid)
                if self.tiers.promote(cid):
                    telemetry.stage_add("index.promotions")

    def _scoring_block(self, cid: int, res_at_probe: str) -> Optional[_ClusterPages]:
        """The block to score. A cluster frozen at probe time counts its
        surfaced stall: ~0 when the prefetch overlap hid the load."""
        if res_at_probe == "spilled":
            t0 = time.perf_counter()
            block = self.tiers.wait_loaded(cid, timeout=0.05)
            if block is None:
                block = self.tiers.unspill(cid)
            if block is None:
                # a slow stage is still in flight: wait it out (skipping the
                # cluster would change results)
                block = self.tiers.wait_loaded(cid, timeout=30.0)
                if block is None and self.tiers.residency(cid) != "absent":
                    raise TieredIndexError(
                        f"cluster {cid} pages never arrived from the spill "
                        "tier (stage wedged or object store unreachable)"
                    )
            stall = time.perf_counter() - t0
            self.stats["prefetch_stall_s"] += stall
            histogram("pathway_ivf_prefetch_stall_seconds").observe(stall)
            telemetry.stage_add("index.prefetch_stall_s", stall)
            return block
        res = self.tiers.residency(cid)
        if res in ("hot", "cold"):
            with self.tiers._cv:
                return self.tiers.pages.get(cid)
        if res == "absent":
            return None  # empty cluster: nothing to score
        block = self.tiers.wait_loaded(cid, timeout=0.05)
        return block if block is not None else self.tiers.unspill(cid)

    def _scoring_payload(self, cid: int, block: _ClusterPages) -> Tuple[torch.Tensor, ...]:
        """The block's payload on the scoring device: its hot mirror (the
        scoring stream waits on the mirror's copy), else its host payload
        staged for this search."""
        dev = self.device
        if dev.type == "cpu":
            return _to_device(block.payload(), dev)
        with self.tiers._cv:
            mirror = self.tiers.hot.get(cid)
        if isinstance(mirror, _Mirror) and mirror.n == block.n:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(mirror.event)
            for t in mirror.tensors:
                t.record_stream(stream)  # a later eviction frees after this search
            return mirror.tensors
        arrays = block.payload()
        self.stats["staged_blocks"] += 1
        self.stats["staged_bytes"] += sum(int(a.nbytes) for a in arrays)
        return _to_device(arrays, dev)

    def _host_queries(self, queries: Any) -> np.ndarray:
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().to(torch.float32).cpu().numpy()
        return np.asarray(queries, dtype=np.float32).reshape(-1, self.dim)

    def _probe_table(self) -> knn_quant.ProbeTable:
        """The int8 coarse probe's centroid table on the scoring device,
        copied and checked once per set of centroids."""
        qc = self._quant_cents()
        if self._qcents_dev is None:
            self._qcents_dev = knn_quant.ProbeTable(
                *(torch.from_numpy(a).to(self.device) for a in qc))
        return self._qcents_dev

    def search_batch(self, queries: Any, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (scores (q,k), slots (q,k), valid_mask (q,k)). Callers on
        several threads (the engine's commit loop, direct callers) take
        turns."""
        with self._search_lock:
            return self._search_batch(queries, k)

    def _search_batch(self, queries: Any, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ready = self._prepare_search()
        q = self._host_queries(queries)
        nq = q.shape[0]
        k_eff = max(1, k)
        if not ready:
            return (
                np.full((nq, k_eff), -np.inf, dtype=np.float32),
                np.full((nq, k_eff), -1, dtype=np.int64),
                np.zeros((nq, k_eff), dtype=bool),
            )
        from pathway_tpu_torch.engine.brownout import get_brownout

        self._batches += 1
        shift = get_brownout().nprobe_shift()
        n_probe = max(1, min(self.n_probe >> shift, self.n_clusters))
        cents = self._cents
        quant = self._qblocks
        qn = np.sum(q * q, axis=1)
        if quant:
            # the int8 coarse probe and block scorer build a shortlist; the
            # exact fp32 rescore below is the only source of returned scores.
            # The padded codes, their scales and |q|^2 go to the card in one
            # copy; the probe reads the padded rows, the scorer the first nq
            q_codes, q_scales = knn_quant.quantize_queries(q)
            q_pad = next_pow2(max(8, nq))
            pq, ps, qn_t = self._stage.send(
                ((q_codes, q_pad, 0), (q_scales, q_pad, 1.0), (qn, nq, 0)))
            aff = self._probe_table().scores(pq, ps, self._stage.stream)[:nq]
            aff = self._stage.fetch(aff)[:, : self.n_clusters]
        else:
            cn = np.sum(cents * cents, axis=1)
            aff = 2.0 * q @ cents.T - cn[None, :]
        if n_probe < self.n_clusters:
            probe = np.argpartition(aff, -n_probe, axis=1)[:, -n_probe:]
        else:
            probe = np.broadcast_to(
                np.arange(self.n_clusters), (nq, self.n_clusters)
            ).copy()
        probed, counts = np.unique(probe, return_counts=True)
        # residency census at probe time, before any staging moves it
        at_probe = {int(c): self.tiers.residency(int(c)) for c in probed}
        n_hot = sum(1 for r in at_probe.values() if r == "hot")
        n_cold = sum(1 for r in at_probe.values() if r == "cold")
        n_spilled = sum(1 for r in at_probe.values() if r == "spilled")
        self.stats["probe_hot"] += n_hot
        self.stats["probe_cold"] += n_cold
        self.stats["probe_spilled"] += n_spilled
        telemetry.stage_add_many({
            "index.probes": float(len(probed)),
            "index.probe_hot": float(n_hot),
            "index.probe_cold": float(n_cold),
            "index.probe_spilled": float(n_spilled),
        })
        # a browned-out probe set never promotes: rung 2 would evict the
        # real working set for half of it
        self._touch(probed, counts, allow_promote=shift == 0)
        # name every probed frozen cluster to the prefetcher before scoring,
        # so its load overlaps the staging of the others
        frozen = [cid for cid, r in at_probe.items() if r == "spilled"]
        if frozen and self._prefetch_on:
            self._prefetcher.request(self.tiers, frozen, promote=False)
        order_ids = sorted(
            at_probe, key=lambda c: 0 if at_probe[c] in ("hot", "cold") else 1
        )
        blocks: Dict[int, _ClusterPages] = {}
        widths: Dict[int, int] = {}
        for cid in order_ids:
            block = self._scoring_block(cid, at_probe[cid])
            if block is not None and block.n > 0:
                blocks[cid] = block
                widths[cid] = block.n
        # per-query candidate layout: query i's probed clusters side by side
        pc = np.array(
            [[widths.get(int(c), 0) for c in row] for row in probe], dtype=np.int64
        )
        col0 = np.zeros_like(pc)
        np.cumsum(pc[:, :-1], axis=1, out=col0[:, 1:])
        W = int(pc.sum(axis=1).max()) if nq else 0
        if W == 0:
            return (
                np.full((nq, k_eff), -np.inf, dtype=np.float32),
                np.full((nq, k_eff), -1, dtype=np.int64),
                np.zeros((nq, k_eff), dtype=bool),
            )
        flatc = probe.ravel()
        flatq = np.repeat(np.arange(nq), probe.shape[1])
        flats = col0.ravel()
        order = np.argsort(flatc, kind="stable")
        fc, fq, fs = flatc[order], flatq[order], flats[order]
        uniq, first = np.unique(fc, return_index=True)
        bounds = np.append(first, len(fc))
        # one work list for the batch: every probed block, on the card
        buf_i = np.full((nq, W), -1, dtype=np.int64)
        payloads: List[Tuple[torch.Tensor, ...]] = []
        offsets, gq, gcol = [0], [], []
        for g in range(len(uniq)):
            cid = int(uniq[g])
            block = blocks.get(cid)
            if block is None:
                continue
            qs, ds = fq[bounds[g] : bounds[g + 1]], fs[bounds[g] : bounds[g + 1]]
            payloads.append(self._scoring_payload(cid, block))
            gq.append(qs)
            gcol.append(ds)
            offsets.append(offsets[-1] + len(qs))
            n = block.n
            cols = ds[:, None] + np.arange(n)[None, :]
            buf_i[qs[:, None], cols] = np.where(block.valid[:n], block.slots[:n], -1)
        groups = BlockGroups(
            np.asarray(offsets, dtype=np.int64), np.concatenate(gq), np.concatenate(gcol)
        )
        if quant:
            out = quant_score_blocks(payloads, groups, pq[:nq], ps[:nq], qn_t, W, self.metric)
        else:
            q_t, qn_t = self._stage.send(((q, nq, 0), (qn, nq, 0)))
            out = score_blocks(payloads, groups, q_t, qn_t, W, self.metric)
        buf_s = out.cpu().numpy()
        if quant:
            scores, idx = self._exact_rescore(
                q, qn, buf_s, buf_i, blocks, k_eff, W, probe, col0
            )
        else:
            scores, idx = topk_rows(buf_s, buf_i, k_eff)
        # per-batch tier observability (hit rate at the probe census, occupancy)
        total = n_hot + n_cold + n_spilled
        if total > 0:
            histogram("pathway_ivf_tier_hit_ratio").observe((n_hot + n_cold) / total)
        histogram("pathway_ivf_tier_occupancy_ratio").observe(self.tiers.occupancy())
        return scores, idx, np.isfinite(scores)

    def _exact_rescore(
        self,
        q: np.ndarray,
        qn: np.ndarray,
        buf_s: np.ndarray,
        buf_i: np.ndarray,
        blocks: Dict[int, _ClusterPages],
        k_eff: int,
        width: int,
        probe: "np.ndarray | None" = None,
        col0: "np.ndarray | None" = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The exact fp32 rescore (host, the reference's code): take the int8
        shortlist ``max(k, PATHWAY_IVF_RESCORE_K)`` deep (clamped to the
        candidate width), gather the fp32 rows of every shortlisted slot and
        recompute their scores through :func:`knn_quant.rescore_pairs`. The
        top-k ranks by exact scores only."""
        nq = q.shape[0]
        depth = min(width, max(k_eff, rescore_k()))
        if nq == 1:
            part = np.argpartition(buf_s[0], -depth)[-depth:][None, :]
            ap_i = buf_i[0][part[0]][None, :]
        else:
            part = np.argpartition(buf_s, -depth, axis=1)[:, -depth:]
            ap_i = np.take_along_axis(buf_i, part, axis=1)
        flat = ap_i.ravel()
        if nq == 1 and probe is not None:
            # solo: a shortlist column maps to its (cluster, row) through the
            # buffer layout itself (col0 holds each probed cluster's start)
            j = np.searchsorted(col0[0], part[0], side="right") - 1
            cids = probe[0][j]
            poss = part[0] - col0[0][j]
            dead = flat < 0
            if dead.any():
                cids = np.where(dead, np.int64(-1), cids)
        else:
            packed = np.fromiter(
                map(self._where.get, flat.tolist(), _repeat(-1)),
                dtype=np.int64, count=flat.size,
            )
            cids = packed >> 32
            poss = packed & 0xFFFFFFFF
        order = np.argsort(cids, kind="stable")
        sc, sp = cids[order], poss[order]
        sok = sc >= 0
        svecs = np.empty((flat.size, self.dim), dtype=np.float32)
        snorms = np.empty(flat.size, dtype=np.float32)
        neq = np.empty(sc.size, dtype=bool)
        neq[0] = True
        np.not_equal(sc[1:], sc[:-1], out=neq[1:])
        starts = np.flatnonzero(neq)
        ends = np.append(starts[1:], sc.size)
        for a, b in zip(starts.tolist(), ends.tolist()):
            cid = int(sc[a])
            if cid < 0:
                continue
            blk = blocks.get(cid)
            if blk is None:
                blk = self._block(cid, create=False)
            if blk is None:
                sok[a:b] = False
                continue
            rows = sp[a:b]
            np.take(blk.vecs, rows, axis=0, out=svecs[a:b])
            np.take(blk.norms, rows, out=snorms[a:b])
        if nq == 1:
            qg = np.repeat(q, flat.size, axis=0)
            qng = np.repeat(qn, flat.size)
        else:
            qis = np.repeat(np.arange(nq), depth)[order]
            qg, qng = q[qis], qn[qis]
        sexact = knn_quant.rescore_pairs(qg, svecs, snorms, qng, self.metric)
        n_ok = int(sok.sum())
        if n_ok < flat.size:
            sexact = np.where(sok, sexact, np.float32(-np.inf))
        exact = np.empty(flat.size, dtype=np.float32)
        exact[order] = sexact
        exact = exact.reshape(nq, depth)
        hist = self._rescore_hist
        if hist is None:
            hist = self._rescore_hist = histogram("pathway_ivf_quant_rescore_depth")
        hist.observe(float(depth))
        telemetry.stage_add_many({
            "index.quant.batches": 1.0,
            "index.quant.rescored_pairs": float(n_ok),
            "index.quant.rescore_depth": float(depth),
        })
        if depth < k_eff:
            # starved shortlist (width < k): topk_rows pads to the contract
            return topk_rows(exact, ap_i, k_eff)
        # a stable sort keeps the ranking a pure function of (exact scores,
        # shortlist order), which residency leaves bitwise the same
        if nq == 1:
            e = exact[0]
            top = np.argsort(-e, kind="stable")[:k_eff]
            out_s = e[top][None, :]
            out_i = ap_i[0][top].astype(np.int64, copy=False)[None, :]
        else:
            top = np.argsort(-exact, axis=1, kind="stable")[:, :k_eff]
            out_s = np.take_along_axis(exact, top, axis=1)
            out_i = np.take_along_axis(ap_i, top, axis=1).astype(np.int64, copy=False)
        out_i[~np.isfinite(out_s)] = -1
        return out_s, out_i

    # -- export / lifecycle ----------------------------------------------------

    def export_rows(self) -> Tuple[List[Any], np.ndarray]:
        """Every live (key, vector) pair as host arrays."""
        self._flush()
        keys: List[Any] = []
        parts: List[np.ndarray] = []
        if self._untrained_slots:
            keys.extend(self.key_of[s] for s in self._untrained_slots)
            parts.append(np.stack(self._untrained_vecs))
        seen_cids = set(loc >> 32 for loc in self._where.values())
        for cid in sorted(seen_cids):
            block = self._block(cid, create=False)
            if block is None:
                continue
            slots, vecs, _norms = block.live_rows()
            keep = [j for j, s in enumerate(slots.tolist()) if s in self.key_of]
            keys.extend(self.key_of[int(slots[j])] for j in keep)
            parts.append(vecs[keep])
        if not keys:
            return keys, np.zeros((0, self.dim), dtype=np.float32)
        return keys, np.concatenate(parts).astype(np.float32, copy=False)

    @property
    def quant(self) -> str:
        """The resolved quantization mode ("off" | "int8")."""
        return self._quant

    def quant_state(self) -> Dict[str, Any]:
        """The mode plus every resident cluster's per-page scale / zero-point
        sidecars (copies)."""
        if self._quant == "off":
            return {"mode": "off"}
        self._flush()
        clusters: Dict[int, Dict[str, Any]] = {}
        with self.tiers._cv:
            pages = dict(self.tiers.pages)
        for cid, block in pages.items():
            if block is None or block.n == 0 or not block.quant:
                continue
            clusters[int(cid)] = {
                "rows": int(block.n),
                "qscale": block.qscale.copy(),
                "qzero": block.qzero.copy(),
            }
        return {"mode": self._quant, "dtype": "int8", "clusters": clusters}

    def quant_recall_audit(self, queries: Any, k: int = 10) -> float:
        """Recall@k of this store against an exact fp32 scan of the live
        corpus (an audit path, never serving)."""
        q = self._host_queries(queries)
        _scores, idx, valid = self.search_batch(q, k)
        keys, vecs = self.export_rows()
        if not keys:
            return 1.0
        norms = np.sum(vecs * vecs, axis=1)
        qn = np.sum(q * q, axis=1)
        exact = knn_quant.host_metric_scores(q, vecs, norms, qn, self.metric)
        kk = min(k, len(keys))
        hits = 0
        for i in range(q.shape[0]):
            top = np.argpartition(exact[i], -kk)[-kk:]
            truth = {keys[j] for j in top}
            got = {
                self.key_of.get(int(s))
                for s, v in zip(idx[i], valid[i]) if v and s >= 0
            }
            hits += len(truth & got)
        ratio = hits / max(q.shape[0] * kk, 1)
        histogram("pathway_ivf_quant_recall_ratio").observe(ratio)
        telemetry.stage_add("index.quant.recall_audits")
        return ratio

    def attach_spill(self, store: Any, prefix: str = "ivf-spill") -> None:
        """Enable the frozen tier behind any object store (put / get / list /
        delete)."""
        with self.tiers._cv:
            self.tiers.spill_store = store
            self.tiers.spill_prefix = prefix

    def tier_stats(self) -> Dict[str, Any]:
        counts = self.tiers.counts()
        out = dict(self.stats)
        out.update(counts)
        out["generation"] = self.generation
        out["n_clusters"] = self.n_clusters
        out["quant"] = self._quant
        out["hot_bytes"] = self.tiers.hot_bytes
        out["budget_bytes"] = self._budget_bytes
        out["occupancy"] = self.tiers.occupancy()
        out["rebuild_inflight"] = self._rebuild_inflight()
        out["query_sends"] = self._stage.sends
        return out

    def close(self) -> None:
        """Join the worker threads; the store stays usable (workers respawn
        lazily)."""
        self._prefetcher.close()
        with self._mu:
            thread = self._rebuild_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=30.0)


def _rebuild_split_pass(
    cents: np.ndarray,
    pages: Dict[int, _ClusterPages],
    dim: int,
    base_clusters: int,
    *,
    quant: bool = False,
) -> Tuple[np.ndarray, Dict[int, _ClusterPages]]:
    """Split oversized clusters of a freshly built generation (bounds the
    per-probe width like the first train's splits)."""
    total = sum(b.n_live for b in pages.values())
    cap = TieredIvfKnnStore._cap_for(total, max(len(cents), 1))
    limit = 2 * base_clusters
    cents_list = [cents]
    for _ in range(6):
        n_now = sum(c.shape[0] for c in cents_list)
        over = [cid for cid, b in pages.items() if b.n_live > cap]
        if not over or n_now + len(over) > limit:
            break
        for cid in over:
            block = pages[cid]
            slots, vecs, norms = block.live_rows()
            g1 = _two_means(vecs)
            if not g1.any() or g1.all():
                continue
            new_cid = sum(c.shape[0] for c in cents_list)
            keep = _ClusterPages(dim, cap=max(PAGE, int((~g1).sum())), quant=quant)
            keep.append(slots[~g1], vecs[~g1], norms[~g1])
            moved = _ClusterPages(dim, cap=max(PAGE, int(g1.sum())), quant=quant)
            moved.append(slots[g1], vecs[g1], norms[g1])
            pages[cid] = keep
            pages[new_cid] = moved
            all_c = np.concatenate(cents_list)
            all_c[cid] = vecs[~g1].mean(axis=0)
            cents_list = [all_c, vecs[g1].mean(axis=0)[None, :]]
    return np.concatenate(cents_list).astype(np.float32), pages


def _record_event(kind: str, **details: Any) -> None:
    try:
        get_flight_recorder().record_event(kind, **details)
    except Exception:  # observability must never kill the serving path
        pass
