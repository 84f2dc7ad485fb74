"""The tiered IVF store's cluster-block scorers: one search batch's work list,
the plain PyTorch versions and the card wrappers of ``csrc/score_blocks.cu``.

A search batch probes a set of cluster blocks; each probed block is scored
against the queries that probe it, and each query's scores land at the
block's start column of that query's row in a ``(nq, W)`` buffer (the
reference's ``buf_s`` layout, ``knn_tiers.search_batch``). Cells no block
writes stay -inf. A block's payload is a tuple of tensors on one device:
``(vecs, norms, mask)`` for fp32 blocks, ``(codes, row_scales, norms,
mask)`` for int8 blocks, all of its first ``n`` rows (``mask`` is the
additive 0 / -inf validity mask).

- :func:`score_blocks` (fp32) replaces the reference's
  ``knn_tiers._score_block_kernel``;
- :func:`quant_score_blocks` (int8) replaces ``knn_quant.quant_score_block_kernel``.

Each launches one kernel for the whole batch for tensors on the card and
takes its plain version for tensors on the CPU; nothing falls back. The
work list is checked, built and copied to the card anew for every call:
a block staged for one search is freed after it, and the caching allocator
hands its address to the next search's block, so nothing keyed on an
address may outlive a call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pathway_tpu_torch.ops import _cuda
from pathway_tpu_torch.ops.knn_quant import (
    SCORE_BLOCKS_SOURCE,
    quant_score_block_plain,
    sqrt_rn,
)

SCORE_BLOCKS = "score_blocks"
QUANT_SCORE_BLOCKS = "quant_score_blocks"
for _name in (SCORE_BLOCKS, QUANT_SCORE_BLOCKS):
    _cuda.KERNEL_LAUNCHES.setdefault(_name, 0)

TILE = 128  # rows per thread block of the fp32 kernel
INT8_MAX_DIM = 12288  # widest int8 row for which two stages of the kernel's ring fit
_METRICS = {"l2sq": 0, "cos": 1, "ip": 2}
_ELEMENT_BYTES = {torch.int8: 1, torch.float32: 4}


class BlockGroups(NamedTuple):
    """Which queries score each block, and where: block ``b``'s entries are
    ``offsets[b] .. offsets[b + 1] - 1``; entry ``e`` scores query
    ``queries[e]`` into columns ``cols[e] .. cols[e] + n_b - 1``."""

    offsets: np.ndarray  # (n_blocks + 1,) int64
    queries: np.ndarray  # (n_entries,) int64
    cols: np.ndarray     # (n_entries,) int64


def score_block_plain(
    vecs: torch.Tensor, norms: torch.Tensor, mask: torch.Tensor,
    queries: torch.Tensor, qn: torch.Tensor, metric: str,
) -> torch.Tensor:
    """Plain version of the reference's ``_score_block_kernel`` over one
    block: (g, n) exact f32 scores with the host path's metric epilogue
    (``knn_quant.host_metric_scores``) and the additive mask. ``qn`` is the
    queries' |q|^2 as the host computes it."""
    dot = queries @ vecs.T
    if metric == "l2sq":
        s = 2.0 * dot - norms[None, :] - qn[:, None]
    elif metric == "cos":
        s = dot / torch.clamp(sqrt_rn(qn)[:, None] * sqrt_rn(norms)[None, :], min=1e-30)
    else:  # ip
        s = dot
    return s + mask[None, :]


def _scatter_plain(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups, nq: int, width: int,
    score_one,
) -> torch.Tensor:
    dev = blocks[0][0].device if blocks else torch.device("cpu")
    out = torch.full((nq, width), -np.inf, dtype=torch.float32, device=dev)
    for b, payload in enumerate(blocks):
        lo, hi = int(groups.offsets[b]), int(groups.offsets[b + 1])
        n = payload[0].shape[0]
        if hi == lo or n == 0:
            continue
        qs = torch.from_numpy(groups.queries[lo:hi]).to(dev)
        ds = torch.from_numpy(groups.cols[lo:hi]).to(dev)
        cols = ds[:, None] + torch.arange(n, device=dev)[None, :]
        out[qs[:, None], cols] = score_one(payload, qs)
    return out


def score_blocks_plain(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, qn: torch.Tensor, width: int, metric: str,
) -> torch.Tensor:
    """Plain version of :func:`score_blocks`: each block through
    :func:`score_block_plain`, its scores scattered to their columns."""
    return _scatter_plain(
        blocks, groups, queries.shape[0], width,
        lambda p, qs: score_block_plain(p[0], p[1], p[2], queries[qs], qn[qs], metric),
    )


def quant_score_blocks_plain(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    q_codes: torch.Tensor, q_scales: torch.Tensor, qn: torch.Tensor, width: int, metric: str,
) -> torch.Tensor:
    """Plain version of :func:`quant_score_blocks`: each block through
    :func:`~pathway_tpu_torch.ops.knn_quant.quant_score_block_plain`."""
    return _scatter_plain(
        blocks, groups, q_codes.shape[0], width,
        lambda p, qs: quant_score_block_plain(
            p[0], p[1], p[2], p[3], q_codes[qs], q_scales[qs], qn[qs], metric
        ),
    )


def score_blocks(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, qn: torch.Tensor, width: int, metric: str,
) -> torch.Tensor:
    """(nq, width) f32 scores of fp32 blocks ``(vecs, norms, mask)``: the
    CUDA kernel for tensors on the card, the plain version on the CPU."""
    if queries.device.type == "cpu":
        return score_blocks_plain(blocks, groups, queries, qn, width, metric)
    return _score_blocks_cuda(0, blocks, groups, queries, None, qn, width, metric)


def quant_score_blocks(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    q_codes: torch.Tensor, q_scales: torch.Tensor, qn: torch.Tensor, width: int, metric: str,
) -> torch.Tensor:
    """(nq, width) f32 approximate scores of int8 blocks ``(codes,
    row_scales, norms, mask)``: the CUDA kernel for tensors on the card, the
    plain version on the CPU."""
    if q_codes.device.type == "cpu":
        return quant_score_blocks_plain(blocks, groups, q_codes, q_scales, qn, width, metric)
    return _score_blocks_cuda(1, blocks, groups, q_codes, q_scales, qn, width, metric)


def check_row_width(d: int, dtype: torch.dtype) -> None:
    """The kernels read rows in 16-byte copies: ``d`` must be a multiple of 4
    for fp32 blocks and of 16 for int8 blocks, and at most
    :data:`INT8_MAX_DIM` for int8 blocks. Raises ``ValueError``."""
    per_copy = 16 // _ELEMENT_BYTES[dtype]
    if d <= 0 or d % per_copy:
        raise ValueError(f"d={d} must be a multiple of {per_copy} for {dtype} blocks "
                         f"on the card (16-byte row copies)")
    if dtype == torch.int8 and d > INT8_MAX_DIM:
        raise ValueError(f"d={d} is wider than the int8 block scorer's {INT8_MAX_DIM} columns")


def tile_rows(d: int) -> int:
    """Rows per tile of the int8 kernel at row width ``d``: 128 up to
    d = 384, fewer (a multiple of 8, at least 8) for wider rows, so that a
    tile stays near 48 KB."""
    return max(8, min(128, (49152 // d) // 8 * 8))


def work_table(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups, mode: int
) -> Tuple[np.ndarray, int, List[int]]:
    """One batch's work list as one int64 host array, and its tile count.

    int8 (mode 1): per block its four payload pointers, its row count and
    its first tile (6 words; a block with rows and queries has
    ``ceil(n / tile_rows(d))`` tiles, any other none), then the group
    offsets, queries and columns: ``6 b + b + 1 + 2 e`` words for ``b``
    blocks and ``e`` entries. fp32 (mode 0): per block its pointers and row
    count (6 words), the group offsets, one word ``(block << 32) | first
    row`` per 128-row tile, then the entries. Raises ``ValueError`` when a
    tensor the kernel copies in 16-byte pieces (every int8 payload tensor,
    the fp32 rows) does not start on a 16-byte boundary. Returns (table,
    n_tiles, section offsets)."""
    off = groups.offsets.tolist()
    r = tile_rows(blocks[0][0].shape[1]) if mode == 1 and blocks else TILE
    head: List[int] = []
    tiles: List[np.ndarray] = []
    n_tiles = 0
    for b, payload in enumerate(blocks):
        n = payload[-1].numel()  # the mask's rows
        ptrs = [t.data_ptr() for t in payload]
        if mode == 1:
            head += ptrs
            head += (n, n_tiles)
            aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15
        else:
            head += (ptrs[0], 0, ptrs[1], ptrs[2], n, 0)
            aligned = not ptrs[0] & 15
        if not aligned:
            raise ValueError(f"block {b}: its payload does not start on a 16-byte boundary")
        if n and off[b + 1] > off[b]:
            k = -(-n // r)
            if mode == 0:
                tiles.append((b << 32) | np.arange(0, n, TILE, dtype=np.int64))
            n_tiles += k
    parts = [np.array(head, dtype=np.int64), groups.offsets]
    if mode == 0:
        parts.append(np.concatenate(tiles) if tiles else np.zeros(0, dtype=np.int64))
    parts += [groups.queries, groups.cols]
    offs = [0]
    for part in parts:
        offs.append(offs[-1] + len(part))
    return np.concatenate(parts).astype(np.int64, copy=False), n_tiles, offs


def check_work(
    mode: int, blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, q_scales: "torch.Tensor | None", qn: torch.Tensor,
    width: int, metric: str,
) -> None:
    """Every check of one batch before its launch, raising ``ValueError``:
    CUDA tensors on one device, the metric, the row width, the queries and
    their scales and norms, each block's payload (count, type, shape, device,
    contiguity) and the groups (they match the blocks, name queries of the
    batch, and keep each block's columns inside the ``(nq, width)``
    output)."""
    name = QUANT_SCORE_BLOCKS if mode == 1 else SCORE_BLOCKS
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    row_dtype = torch.int8 if mode == 1 else torch.float32
    nq, d = queries.shape
    check_row_width(d, row_dtype)
    if queries.dtype != row_dtype or not queries.is_contiguous() or queries.data_ptr() % 16:
        raise ValueError(f"queries must be contiguous {row_dtype} on a 16-byte boundary")
    di, f32 = queries.get_device(), torch.float32
    for t, what in ((qn, "qn"),) + (((q_scales, "q_scales"),) if mode == 1 else ()):
        if t is None or t.get_device() != di or t.dtype is not f32 or t.shape != (nq,) \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous ({nq},) float32 tensor on {dev}")
    n_tensors = 4 if mode == 1 else 3
    ns = []
    for b, payload in enumerate(blocks):
        if len(payload) != n_tensors:
            raise ValueError(f"block {b}: {len(payload)} tensors, expected {n_tensors}")
        rows = payload[0]
        shape = rows.shape
        n = shape[0]
        if rows.dtype is not row_dtype or shape != (n, d) or rows.get_device() != di \
                or not rows.is_contiguous():
            raise ValueError(f"block {b}: rows are {rows.dtype} {tuple(shape)} on "
                             f"{rows.device}, expected contiguous {row_dtype} (n, {d}) on {dev}")
        for t in payload[1:]:
            if t.dtype is not f32 or t.shape != (n,) or t.get_device() != di \
                    or not t.is_contiguous():
                raise ValueError(f"block {b}: a payload tensor is {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}, expected contiguous {f32} with {n} rows")
        ns.append(n)
    if ns and max(ns) >= 2**32:
        raise ValueError(f"a block has {max(ns)} rows")
    off, gq, gcol = groups.offsets, groups.queries, groups.cols
    n_entries = len(gq)
    sizes = off[1:] - off[:-1]
    if len(off) != len(blocks) + 1 or len(gcol) != n_entries or off[0] != 0 \
            or off[-1] != n_entries or (len(sizes) and sizes.min() < 0):
        raise ValueError("groups do not match the blocks")
    if n_entries:
        if gq.min() < 0 or gq.max() >= nq:
            raise ValueError("a group entry names a query outside the batch")
        ends = gcol + np.repeat(ns, sizes)
        if gcol.min() < 0 or ends.max() > width:
            b = int(np.searchsorted(off, np.argmax((gcol < 0) | (ends > width)), side="right"))
            raise ValueError(f"block {b - 1}: its columns leave the (nq, {width}) output")


class _Pinned:
    """A pinned host buffer of :func:`to_card` and the event recorded after
    its last copy (None before the first)."""

    __slots__ = ("host", "array", "event")

    def __init__(self, words: int):
        self.host = torch.empty(words, dtype=torch.int64, pin_memory=True)
        self.array = self.host.numpy()
        self.event = None


_PINNED: Dict[int, List[_Pinned]] = {}  # device index -> free buffers
_PINNED_LOCK = threading.Lock()


def to_card(table: np.ndarray, dev: torch.device, stream=None) -> torch.Tensor:
    """``table`` (int64) as a new tensor on ``dev``, copied on the device's
    current stream (``stream``, when the caller has it already), with no
    host sync and no ``pin_memory()`` of its own: through a pinned buffer of
    a pool kept per device, grown by powers of two, which is taken again
    only once the event recorded after its last copy has completed (a buffer
    still in flight is skipped, and a new one made)."""
    n = len(table)
    stream = stream or torch.cuda.current_stream(dev)
    with _PINNED_LOCK:
        pool = _PINNED.setdefault(stream.device_index, [])
        for i, buf in enumerate(pool):
            if len(buf.array) >= n and (buf.event is None or buf.event.query()):
                pool.pop(i)
                break
        else:
            buf = _Pinned(1 << max(10, (n - 1).bit_length()))
    buf.array[:n] = table
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out.copy_(buf.host[:n], non_blocking=True)
    if buf.event is None:
        buf.event = torch.cuda.Event()
    buf.event.record(stream)
    with _PINNED_LOCK:
        pool.append(buf)
    return out


def _score_blocks_cuda(
    mode: int, blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, q_scales: "torch.Tensor | None", qn: torch.Tensor,
    width: int, metric: str,
) -> torch.Tensor:
    """Check the work list, copy it to the card in one transfer and launch
    the mode's kernel once on the current stream."""
    launch, out = score_blocks_launcher(mode, blocks, groups, queries, q_scales, qn, width, metric)
    launch()
    _cuda.count_launch(QUANT_SCORE_BLOCKS if mode == 1 else SCORE_BLOCKS)
    return out


def _kernel(mode: int):
    lib = _cuda.load(SCORE_BLOCKS_SOURCE)
    fn = lib.pw_quant_score_blocks if mode == 1 else lib.pw_score_blocks
    if fn.argtypes is None:  # first call: pointers must not be cut to 32 bits
        ints = 6 if mode == 1 else 4
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def score_blocks_launcher(
    mode: int, blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, q_scales: "torch.Tensor | None", qn: torch.Tensor,
    width: int, metric: str,
):
    """The checks, the work list and its copy to the card, and the -inf
    output of one batch, done once. Returns ``(launch, out)``: each
    ``launch()`` runs the kernel into ``out`` (nq, width) on the stream that
    was current when the launcher was made, and counts nothing (for timing
    the kernel alone)."""
    check_work(mode, blocks, groups, queries, q_scales, qn, width, metric)
    table_np, n_tiles, offs = work_table(blocks, groups, mode)
    if n_tiles >= 2**31:
        raise ValueError(f"{n_tiles} tiles")
    dev = queries.device
    fn = _kernel(mode)
    stream = torch.cuda.current_stream(queries.get_device())
    out = torch.full((queries.shape[0], width), -np.inf, dtype=torch.float32, device=dev)
    table = to_card(table_np, dev, stream)
    ptr = [table.data_ptr() + 8 * o for o in offs]
    name = QUANT_SCORE_BLOCKS if mode == 1 else SCORE_BLOCKS
    d, metric_id = queries.shape[1], _METRICS[metric]
    if mode == 1:
        args = (*ptr[:4], queries.data_ptr(), q_scales.data_ptr(), qn.data_ptr(),
                out.data_ptr(), width, len(blocks), n_tiles, tile_rows(d), d, metric_id)
    else:
        args = (*ptr[:5], queries.data_ptr(), qn.data_ptr(), out.data_ptr(), width,
                n_tiles, d, metric_id)
    args += (stream.device_index, stream.cuda_stream)

    def launch() -> None:
        _cuda.check(fn(*args), name)
        table.data_ptr()  # the closure keeps the work list alive

    return launch, out
