"""Segment reductions — the groupby-reduce hot path (port of ``pathway_tpu/ops/segment.py``).

A commit's delta rows are assigned dense segment ids (one per touched group)
and reduced per segment:

- float32 batches of at least ``_DEVICE_THRESHOLD`` rows reduce on the
  engine's device with torch ops. Float atomics (``index_add_`` on CUDA)
  depend on the order threads land in, so the device sum is a sort-based
  segmented reduction: a stable sort by segment id, then one
  ``segment_reduce`` over the contiguous runs, which adds each run in one
  fixed order;
- everything else uses exact host kernels (``np.add.at`` / ``np.bincount``):
  int64 sums must not round-trip through float32, and small batches would
  lose to the host↔device copy.

``DEVICE_SUMS`` counts the segment sums run on a device other than the CPU
(``reset_device_sums`` zeroes it), as ``ops/_cuda.py::KERNEL_LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# Below this, host↔device transfer dominates the reduction itself.
_DEVICE_THRESHOLD = 1 << 15

#: segment sums run on a device other than the CPU since the last reset
DEVICE_SUMS = 0


def reset_device_sums() -> None:
    global DEVICE_SUMS
    DEVICE_SUMS = 0


def engine_device() -> Any:
    """The device the running engine offloads to (``pw.run(device=...)``):
    the card unless the run asked for the CPU."""
    from pathway_tpu_torch.device import resolve_device
    from pathway_tpu_torch.engine.expression_evaluator import get_runtime

    return resolve_device(get_runtime().get("device"))


def segment_sum_device(
    values: np.ndarray, segment_ids: np.ndarray, num_segments: int, device: Any
) -> np.ndarray:
    """Sorted segmented sum of a float32 batch on ``device``; returns host f32."""
    global DEVICE_SUMS
    import torch

    if torch.device(device).type != "cpu":
        DEVICE_SUMS += 1
    vals = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)).to(device)
    ids = torch.from_numpy(np.ascontiguousarray(segment_ids, dtype=np.int64)).to(device)
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments)
    sums = torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)
    return sums.cpu().numpy()


def segment_sum(
    values: np.ndarray,
    segment_ids: np.ndarray,
    num_segments: int,
    key_lo: np.ndarray | None = None,
) -> np.ndarray:
    """Sum ``values`` into ``num_segments`` buckets given per-row segment ids.

    Integer inputs reduce in int64 on the host; small float batches reduce on
    the host; float32 batches above the threshold reduce on the engine's
    device. ``key_lo`` (the reference's mesh routing key) is accepted and
    unused: the port runs one device."""
    values = np.asarray(values)
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    if values.dtype == np.float32 and len(values) >= _DEVICE_THRESHOLD:
        return segment_sum_device(values, segment_ids, num_segments, engine_device())
    if values.dtype == object:
        out_obj = np.zeros(num_segments, dtype=object)
        for i in range(len(values)):
            out_obj[segment_ids[i]] = out_obj[segment_ids[i]] + values[i]
        return out_obj
    out = np.zeros(num_segments, dtype=values.dtype if values.dtype.kind == "f" else np.int64)
    np.add.at(out, segment_ids, values)
    return out


def segment_count(
    segment_ids: np.ndarray, num_segments: int, weights: np.ndarray | None = None
) -> np.ndarray:
    """Count rows (or sum integer weights, e.g. +1/-1 diffs) per segment."""
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    if weights is None:
        return np.bincount(segment_ids, minlength=num_segments).astype(np.int64)
    out = np.zeros(num_segments, dtype=np.int64)
    np.add.at(out, segment_ids, np.asarray(weights, dtype=np.int64))
    return out


def segment_slices(
    segment_ids: np.ndarray, num_segments: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort rows by segment: returns (order, starts, ends) such that
    ``order[starts[s]:ends[s]]`` are the row indices of segment ``s`` in input order.
    Segments with no rows get empty slices."""
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    order = np.argsort(segment_ids, kind="stable")
    sorted_ids = segment_ids[order]
    if num_segments is None:
        num_segments = int(sorted_ids[-1]) + 1 if len(sorted_ids) else 0
    starts = np.searchsorted(sorted_ids, np.arange(num_segments), side="left")
    ends = np.searchsorted(sorted_ids, np.arange(num_segments), side="right")
    return order, starts, ends
