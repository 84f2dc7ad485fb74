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
takes its plain version for tensors on the CPU; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

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

TILE = 128  # rows per thread block of the kernel
_METRICS = {"l2sq": 0, "cos": 1, "ip": 2}


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
    """The kernel reads rows in 16-byte copies: ``d`` must be a multiple of 4
    for fp32 blocks and of 16 for int8 blocks. Raises ``ValueError``."""
    per_copy = 16 // torch.empty((), dtype=dtype).element_size()
    if d <= 0 or d % per_copy:
        raise ValueError(f"d={d} must be a multiple of {per_copy} for {dtype} blocks "
                         f"on the card (16-byte row copies)")


def work_table(
    blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups, mode: int
) -> Tuple[np.ndarray, int, List[int]]:
    """The kernel's work list as one int64 host array: per block its
    payload pointers and row count (6 words), the group offsets, the row
    tiles ``(block << 32) | first row`` and the group entries' queries and
    columns. Returns (table, n_tiles, section offsets)."""
    n_blocks = len(blocks)
    head = np.zeros((n_blocks, 6), dtype=np.int64)
    tiles: List[np.ndarray] = []
    for b, payload in enumerate(blocks):
        if mode == 1:
            rows, srow, norms, mask = payload
            head[b, 1] = srow.data_ptr()
        else:
            rows, norms, mask = payload
        n = rows.shape[0]
        head[b, 0], head[b, 2], head[b, 3], head[b, 4] = (
            rows.data_ptr(), norms.data_ptr(), mask.data_ptr(), n)
        if n and groups.offsets[b + 1] > groups.offsets[b]:
            tiles.append((b << 32) | np.arange(0, n, TILE, dtype=np.int64))
    tile_arr = np.concatenate(tiles) if tiles else np.zeros(0, dtype=np.int64)
    parts = [head.reshape(-1), groups.offsets.astype(np.int64), tile_arr,
             groups.queries.astype(np.int64), groups.cols.astype(np.int64)]
    offs = np.cumsum([0] + [len(p) for p in parts]).tolist()
    return np.concatenate(parts), len(tile_arr), offs


def _score_blocks_cuda(
    mode: int, blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, q_scales: "torch.Tensor | None", qn: torch.Tensor,
    width: int, metric: str,
) -> torch.Tensor:
    """Check the work list, copy it to the card in one transfer and launch
    ``pw_score_blocks`` once on the current stream."""
    launch, out = score_blocks_launcher(mode, blocks, groups, queries, q_scales, qn, width, metric)
    launch()
    _cuda.count_launch(QUANT_SCORE_BLOCKS if mode == 1 else SCORE_BLOCKS)
    return out


def score_blocks_launcher(
    mode: int, blocks: Sequence[Tuple[torch.Tensor, ...]], groups: BlockGroups,
    queries: torch.Tensor, q_scales: "torch.Tensor | None", qn: torch.Tensor,
    width: int, metric: str,
):
    """The checks and the work list's transfer of one batch, done once.
    Returns ``(launch, out)``: each ``launch()`` runs the kernel on the
    current stream into ``out`` (nq, width), and counts nothing (for timing
    the kernel alone)."""
    name = QUANT_SCORE_BLOCKS if mode == 1 else SCORE_BLOCKS
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    row_dtype = torch.int8 if mode == 1 else torch.float32
    nq, d = queries.shape
    check_row_width(d, row_dtype)
    want = ((row_dtype, 2), (torch.float32, 1), (torch.float32, 1), (torch.float32, 1))
    want = want if mode == 1 else (want[0],) + want[2:]
    if queries.dtype != row_dtype or not queries.is_contiguous() or queries.data_ptr() % 16:
        raise ValueError(f"queries must be contiguous {row_dtype} on a 16-byte boundary")
    for t, what in ((qn, "qn"),) + (((q_scales, "q_scales"),) if mode == 1 else ()):
        if t is None or t.device != dev or t.dtype != torch.float32 or t.shape != (nq,) \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous ({nq},) float32 tensor on {dev}")
    for b, payload in enumerate(blocks):
        if len(payload) != len(want):
            raise ValueError(f"block {b}: {len(payload)} tensors, expected {len(want)}")
        n = payload[0].shape[0]
        for t, (dtype, ndim) in zip(payload, want):
            if t.device != dev or t.dtype != dtype or t.dim() != ndim or t.shape[0] != n \
                    or not t.is_contiguous():
                raise ValueError(f"block {b}: a payload tensor is {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}, expected contiguous {dtype} with {n} rows")
        if payload[0].shape[1] != d or payload[0].data_ptr() % 16:
            raise ValueError(f"block {b}: rows must be (n, {d}) on a 16-byte boundary")
        if n >= 2**32:
            raise ValueError(f"block {b}: {n} rows")
    if len(groups.offsets) != len(blocks) + 1 or len(groups.queries) != len(groups.cols):
        raise ValueError("groups do not match the blocks")
    if len(groups.queries) and (groups.queries.min() < 0 or groups.queries.max() >= nq):
        raise ValueError("a group entry names a query outside the batch")
    for b, payload in enumerate(blocks):
        lo, hi = int(groups.offsets[b]), int(groups.offsets[b + 1])
        if hi > lo and (groups.cols[lo:hi].min() < 0
                        or groups.cols[lo:hi].max() + payload[0].shape[0] > width):
            raise ValueError(f"block {b}: its columns leave the (nq, {width}) output")
    table_np, n_tiles, offs = work_table(blocks, groups, mode)
    if n_tiles >= 2**31:
        raise ValueError(f"{n_tiles} tiles")
    out = torch.full((nq, width), -np.inf, dtype=torch.float32, device=dev)
    table = torch.from_numpy(table_np).pin_memory().to(dev, non_blocking=True)
    ptr = [table.data_ptr() + 8 * o for o in offs]
    fn = _cuda.load(SCORE_BLOCKS_SOURCE).pw_score_blocks
    if fn.argtypes is None:  # first call: pointers must not be cut to 32 bits
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    scales_ptr = q_scales.data_ptr() if mode == 1 else None

    def launch() -> None:
        with torch.cuda.device(dev):
            rc = fn(
                mode, ptr[0], ptr[1], ptr[2], ptr[3], ptr[4], queries.data_ptr(), scales_ptr,
                qn.data_ptr(), out.data_ptr(), width, n_tiles, d, _METRICS[metric],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _cuda.check(rc, name)
        table.data_ptr()  # the closure keeps the work list alive

    return launch, out
