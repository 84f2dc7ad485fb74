"""Incremental aggregation reducers (port of ``pathway_tpu/internals/reducers.py``).

Semigroup reducers (count / sum / avg, ``semigroup = True``) update in O(1)
on insert AND retract; the others (min / max / argmin / argmax / unique /
any / tuple / sorted_tuple / ndarray / earliest / latest and the custom and
UDF reducers) keep a per-group multiset and recompute on change. Large
float32 sums (``sum`` and ``avg``) reduce on the engine's device
(``ops/segment.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Iterable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr


class Reducer:
    """Descriptor of an aggregation; the engine keeps ONE columnar state per reducer
    leaf (``make_state``), holding every group's accumulation in slot-indexed arrays —
    per-group reducer implementations flattened into
    struct-of-arrays so a whole commit updates in vectorized segment kernels."""

    name = "reducer"
    semigroup = False  # True when a retraction is O(1) (subtractable)
    n_args = 1

    def make(self) -> "Accumulator":
        raise NotImplementedError

    def make_state(self) -> "ColumnarState":
        return _ObjectState(self)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.ANY

    def __call__(self, *args: Any, **kwargs: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(self, *args, **kwargs)


class ColumnarState:
    """Slot-indexed accumulator storage for one reducer leaf across ALL groups.

    ``update`` applies one commit's rows: ``slots[i]`` is row i's group slot,
    ``uniq_slots``/``inverse`` the batch's dense segmentation (``inverse[i]`` indexes
    ``uniq_slots``), ``diffs`` the +1/-1 multiplicities. ``key_lo`` carries the group
    keys' low bits so float segment sums can ride the mesh exchange
    (``ops/segment.py``)."""

    def ensure(self, capacity: int) -> None:
        raise NotImplementedError

    def reset(self, slots: np.ndarray) -> None:
        """Recycled slots start fresh (a new group reused a dead group's slot)."""
        raise NotImplementedError

    def update(
        self,
        slots: np.ndarray,
        uniq_slots: np.ndarray,
        inverse: np.ndarray,
        arrays: list[np.ndarray],
        diffs: np.ndarray,
        cnt_delta: np.ndarray,
        counts_after: np.ndarray,
        key_lo: np.ndarray | None = None,
    ) -> None:
        raise NotImplementedError

    def values(self, slots: np.ndarray) -> np.ndarray:
        """Current aggregate per requested slot (vectorized gather)."""
        raise NotImplementedError


def _grow(arr: np.ndarray, capacity: int, fill: Any = 0) -> np.ndarray:
    if len(arr) >= capacity:
        return arr
    out = np.empty(max(capacity, 2 * len(arr), 16), dtype=arr.dtype)
    out[: len(arr)] = arr
    out[len(arr) :] = fill
    return out


class _CountState(ColumnarState):
    def __init__(self) -> None:
        self.vals = np.zeros(0, dtype=np.int64)

    def ensure(self, capacity: int) -> None:
        self.vals = _grow(self.vals, capacity)

    def reset(self, slots: np.ndarray) -> None:
        self.vals[slots] = 0

    def update(self, slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after, key_lo=None) -> None:
        self.vals[uniq_slots] += cnt_delta

    def values(self, slots: np.ndarray) -> np.ndarray:
        return self.vals[slots]


class _SumState(ColumnarState):
    """Typed segment-summed totals; object/exotic dtypes fall back to a Python pass.

    ``zero_on_empty``: emptied groups snap back to exact 0 (float drift guard), the
    _SumAcc semantics."""

    def __init__(self, zero_on_empty: bool) -> None:
        self.vals: np.ndarray = np.zeros(0, dtype=np.int64)
        self.dtype_locked = False
        self.zero_on_empty = zero_on_empty

    def ensure(self, capacity: int) -> None:
        self.vals = _grow(self.vals, capacity)

    def reset(self, slots: np.ndarray) -> None:
        self.vals[slots] = None if self.vals.dtype == object else 0

    def _lock_dtype(self, incoming: np.ndarray) -> None:
        if self.dtype_locked:
            if incoming.dtype != self.vals.dtype and incoming.dtype != object:
                promoted = np.promote_types(self.vals.dtype, incoming.dtype)
                if promoted != self.vals.dtype:
                    self.vals = self.vals.astype(promoted)
            return
        self.dtype_locked = True
        if incoming.dtype == object or incoming.dtype.kind not in "bif":
            self.vals = self.vals.astype(object)
            self.vals[:] = None  # None = untouched; first insert assigns directly
        elif incoming.dtype.kind == "f":
            self.vals = self.vals.astype(incoming.dtype)

    def update(self, slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after, key_lo=None) -> None:
        vals = np.asarray(arrays[0])
        self._lock_dtype(vals)
        from pathway_tpu_torch.ops.segment import segment_sum

        if self.vals.dtype == object or vals.dtype == object or vals.dtype.kind not in "bif":
            if self.vals.dtype != object:
                self.vals = self.vals.astype(object)
            for i in range(len(vals)):
                s = slots[i]
                contrib = vals[i]
                cur = self.vals[s]
                if diffs[i] > 0:
                    self.vals[s] = contrib if cur is None else cur + contrib
                else:
                    self.vals[s] = cur - contrib
        else:
            weights = diffs if vals.dtype.kind != "f" else diffs.astype(vals.dtype)
            sums = segment_sum(vals * weights, inverse, len(uniq_slots), key_lo=key_lo)
            self.vals[uniq_slots] += sums.astype(self.vals.dtype, copy=False)
        if self.zero_on_empty:
            emptied = uniq_slots[counts_after == 0]
            if len(emptied):
                # emptied groups snap to the pristine state (float-drift guard)
                self.vals[emptied] = None if self.vals.dtype == object else 0

    def values(self, slots: np.ndarray) -> np.ndarray:
        return self.vals[slots]


class _AvgState(_SumState):
    """sum/count; counts mirror the group's signed row count."""

    def __init__(self) -> None:
        super().__init__(zero_on_empty=False)
        self.counts = np.zeros(0, dtype=np.int64)

    def ensure(self, capacity: int) -> None:
        super().ensure(capacity)
        self.counts = _grow(self.counts, capacity)

    def reset(self, slots: np.ndarray) -> None:
        super().reset(slots)
        self.counts[slots] = 0

    def update(self, slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after, key_lo=None) -> None:
        super().update(slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after, key_lo)
        self.counts[uniq_slots] += cnt_delta

    def values(self, slots: np.ndarray) -> np.ndarray:
        sums = self.vals[slots]
        counts = self.counts[slots]
        if sums.dtype == object:
            out = np.empty(len(slots), dtype=object)
            for i in range(len(slots)):
                out[i] = sums[i] / counts[i] if counts[i] else None
            return out
        safe = np.where(counts == 0, 1, counts)
        out = sums / safe
        if (counts == 0).any():
            out = out.astype(object)
            out[counts == 0] = None
        return out


class _ObjectState(ColumnarState):
    """Generic fallback: one Accumulator object per group slot (the recompute-style
    reducers: min/max/unique/tuple/...)."""

    def __init__(self, reducer: "Reducer") -> None:
        self.reducer = reducer
        self.accs = np.empty(0, dtype=object)

    def ensure(self, capacity: int) -> None:
        if len(self.accs) >= capacity:
            return
        old = self.accs
        self.accs = np.empty(max(capacity, 2 * len(old), 16), dtype=object)
        self.accs[: len(old)] = old

    def reset(self, slots: np.ndarray) -> None:
        for s in slots.tolist():
            self.accs[s] = None

    def update(self, slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after, key_lo=None) -> None:
        from pathway_tpu_torch.ops.segment import segment_slices

        order, starts, ends = segment_slices(inverse, len(uniq_slots))
        any_retract = bool(np.any(diffs < 0))
        for j, s in enumerate(uniq_slots.tolist()):
            rows = order[starts[j] : ends[j]]
            if len(rows) == 0:
                continue
            acc = self.accs[s]
            if acc is None:
                acc = self.accs[s] = self.reducer.make()
            if not any_retract:
                acc.insert_many(zip(*(arr[rows] for arr in arrays)))
            else:
                # mixed commit: preserve original row order (retract/insert interleave)
                for i in rows:
                    vals = tuple(arr[i] for arr in arrays)
                    if diffs[i] > 0:
                        acc.insert(vals)
                    else:
                        acc.retract(vals)

    def values(self, slots: np.ndarray) -> np.ndarray:
        out = np.empty(len(slots), dtype=object)
        for i, s in enumerate(slots.tolist()):
            acc = self.accs[s]
            out[i] = acc.value() if acc is not None else None
        return out


class Accumulator:
    def insert(self, values: tuple) -> None:
        raise NotImplementedError

    def retract(self, values: tuple) -> None:
        raise NotImplementedError

    def value(self) -> Any:
        raise NotImplementedError

    def insert_many(self, rows: Iterable[tuple]) -> None:
        for r in rows:
            self.insert(r)

    def retract_many(self, rows: Iterable[tuple]) -> None:
        for r in rows:
            self.retract(r)


class _CountAcc(Accumulator):
    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def insert(self, values: tuple) -> None:
        self.n += 1

    def retract(self, values: tuple) -> None:
        self.n -= 1

    def value(self) -> int:
        return self.n


class CountReducer(Reducer):
    name = "count"
    semigroup = True
    n_args = 0

    def make(self) -> Accumulator:
        return _CountAcc()

    def make_state(self) -> ColumnarState:
        return _CountState()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.INT


class _SumAcc(Accumulator):
    __slots__ = ("total", "n")

    def __init__(self) -> None:
        self.total: Any = 0
        self.n = 0

    def insert(self, values: tuple) -> None:
        self.total = values[0] if self.n == 0 else self.total + values[0]
        self.n += 1

    def retract(self, values: tuple) -> None:
        self.n -= 1
        if self.n == 0:
            self.total = 0
        else:
            self.total = self.total - values[0]

    def value(self) -> Any:
        return self.total


class SumReducer(Reducer):
    name = "sum"
    semigroup = True

    def make(self) -> Accumulator:
        return _SumAcc()

    def make_state(self) -> ColumnarState:
        return _SumState(zero_on_empty=True)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        base = arg_dtypes[0].strip_optional()
        if base in (dt.INT, dt.FLOAT, dt.DURATION) or isinstance(base, dt.Array):
            return base
        return dt.ANY


class _MultisetAcc(Accumulator):
    """Base for non-subtractable reducers: keeps every contribution."""

    __slots__ = ("items",)

    def __init__(self) -> None:
        self.items: Counter = Counter()

    def _key(self, values: tuple) -> Any:
        return values if len(values) != 1 else values[0]

    def insert(self, values: tuple) -> None:
        self.items[_hashable(self._key(values))] += 1

    def retract(self, values: tuple) -> None:
        k = _hashable(self._key(values))
        self.items[k] -= 1
        if self.items[k] == 0:
            del self.items[k]

    def insert_many(self, rows: Iterable[tuple]) -> None:
        # Counter.update over a generator runs at C speed
        self.items.update(_hashable(self._key(r)) for r in rows)

    def retract_many(self, rows: Iterable[tuple]) -> None:
        self.items.subtract(_hashable(self._key(r)) for r in rows)
        for k in [k for k, c in self.items.items() if c == 0]:
            del self.items[k]


def _hashable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return _NdarrayWrap(v)
    if isinstance(v, tuple):
        return tuple(_hashable(x) for x in v)
    return v


def _unhash(v: Any) -> Any:
    if isinstance(v, _NdarrayWrap):
        return v.arr
    if isinstance(v, tuple):
        return tuple(_unhash(x) for x in v)
    return v


class _NdarrayWrap:
    __slots__ = ("arr", "_h")

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self._h = hash((arr.tobytes(), arr.shape))

    def __hash__(self) -> int:
        return self._h

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _NdarrayWrap) and np.array_equal(self.arr, other.arr)

    def _key(self) -> tuple:
        return (self.arr.shape, self.arr.tobytes())

    def __lt__(self, other: "_NdarrayWrap") -> bool:
        return self._key() < other._key()

    def __le__(self, other: "_NdarrayWrap") -> bool:
        return self._key() <= other._key()

    def __gt__(self, other: "_NdarrayWrap") -> bool:
        return self._key() > other._key()

    def __ge__(self, other: "_NdarrayWrap") -> bool:
        return self._key() >= other._key()


class _ExtremeAcc(_MultisetAcc):
    """min / max over the multiset, with the current extreme cached: an insert
    compares against it, and only retracting the extreme itself forces a
    rescan (the reference rescans every item on every read)."""

    __slots__ = ("best", "valid")
    take_max = True

    def __init__(self) -> None:
        super().__init__()
        self.best: Any = None
        self.valid = True

    def _offer(self, k: Any) -> None:
        if k is not None and self.valid and (
            self.best is None or (k > self.best if self.take_max else k < self.best)
        ):
            self.best = k

    def insert(self, values: tuple) -> None:
        k = _hashable(self._key(values))
        self.items[k] += 1
        self._offer(k)

    def insert_many(self, rows: Iterable[tuple]) -> None:
        for r in rows:
            self.insert(r)

    def retract(self, values: tuple) -> None:
        k = _hashable(self._key(values))
        super().retract(values)
        if k not in self.items and k == self.best:
            self.valid = False

    def value(self) -> Any:
        if not self.valid:
            present = [k for k in self.items if k is not None]
            self.best = (max if self.take_max else min)(present) if present else None
            self.valid = True
        return _unhash(self.best) if self.best is not None else None


class _MinAcc(_ExtremeAcc):
    take_max = False


class _MaxAcc(_ExtremeAcc):
    take_max = True


class MinReducer(Reducer):
    name = "min"

    def make(self) -> Accumulator:
        return _MinAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class MaxReducer(Reducer):
    name = "max"

    def make(self) -> Accumulator:
        return _MaxAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class _ArgExtremeAcc(_ExtremeAcc):
    """values = (cmp_value, pointer): the pointer of the extreme (value,
    pointer) pair, cached as ``_ExtremeAcc`` caches min / max."""

    def __init__(self, take_min: bool):
        super().__init__()
        self.take_max = not take_min

    def _key(self, values: tuple) -> Any:
        return values

    def value(self) -> Any:
        best = super().value()
        return best[1] if best is not None else None


class ArgMinReducer(Reducer):
    name = "argmin"
    n_args = 2

    def make(self) -> Accumulator:
        return _ArgExtremeAcc(True)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.POINTER


class ArgMaxReducer(Reducer):
    name = "argmax"
    n_args = 2

    def make(self) -> Accumulator:
        return _ArgExtremeAcc(False)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.POINTER


class _UniqueAcc(_MultisetAcc):
    def value(self) -> Any:
        if len(self.items) != 1:
            from pathway_tpu_torch.engine.columnar import ERROR
            from pathway_tpu_torch.engine.expression_evaluator import get_runtime

            if get_runtime()["terminate_on_error"]:
                # reference semantics: a unique() violation fails the run unless
                # error poisoning was opted into (terminate_on_error=False)
                raise ValueError(
                    "unique reducer: group holds more than one distinct value"
                )
            return ERROR
        return _unhash(next(iter(self.items)))


class UniqueReducer(Reducer):
    name = "unique"

    def make(self) -> Accumulator:
        return _UniqueAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class _AnyAcc(_MultisetAcc):
    """The item whose repr is least (first inserted among equal reprs), cached:
    only retracting that item forces a rescan (the reference rescans every
    item on every read)."""

    def __init__(self) -> None:
        super().__init__()
        self.best: Any = None
        self.best_repr: str | None = None
        self.valid = True

    def insert(self, values: tuple) -> None:
        k = _hashable(self._key(values))
        self.items[k] += 1
        if self.valid:
            r = repr(k)
            if self.best_repr is None or r < self.best_repr:
                self.best, self.best_repr = k, r

    def insert_many(self, rows: Iterable[tuple]) -> None:
        for r in rows:
            self.insert(r)

    def retract(self, values: tuple) -> None:
        k = _hashable(self._key(values))
        super().retract(values)
        if k not in self.items and self.best_repr is not None and k == self.best:
            self.valid = False

    def value(self) -> Any:
        if not self.valid:
            self.best = min(self.items, key=lambda v: repr(v))
            self.best_repr = repr(self.best)
            self.valid = True
        return _unhash(self.best)


class AnyReducer(Reducer):
    name = "any"

    def make(self) -> Accumulator:
        return _AnyAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class _TupleAcc(Accumulator):
    """values = (value, sort_key_or_None); collects a tuple ordered by (sort key,
    insertion). Same output as the reference's accumulator, which scans every
    item on a retraction and sorts every item on a read: here a retraction
    finds its item through an index, and while no sort key is set the tuple
    is the items in insertion order, with no sort."""

    __slots__ = ("items", "where", "counter", "skip_nones", "n_keyed")

    def __init__(self, skip_nones: bool = False):
        self.items: dict = {}  # counter -> (hashable sort key, hashable value, value)
        self.where: dict = {}  # (sort key, value) -> counters, oldest first
        self.counter = 0
        self.skip_nones = skip_nones
        self.n_keyed = 0  # live items whose sort key is not None

    def insert(self, values: tuple) -> None:
        value, sort_key = values
        if self.skip_nones and value is None:
            return
        self.counter += 1
        item = (_hashable(sort_key), _hashable(value))
        self.items[self.counter] = (*item, value)
        self.where.setdefault(item, []).append(self.counter)
        if item[0] is not None:
            self.n_keyed += 1

    def retract(self, values: tuple) -> None:
        value, sort_key = values
        if self.skip_nones and value is None:
            return
        item = (_hashable(sort_key), _hashable(value))
        counters = self.where.get(item)
        if counters:
            c = counters.pop(0)
            if not counters:
                del self.where[item]
        else:
            # equal but not hash-equal: the first equal item in insertion order
            for c, (hs, hv, _v) in self.items.items():
                if hs == item[0] and hv == item[1]:
                    break
            else:
                return
            own = self.where[(hs, hv)]
            own.remove(c)
            if not own:
                del self.where[(hs, hv)]
        if self.items.pop(c)[0] is not None:
            self.n_keyed -= 1

    def value(self) -> tuple:
        if self.n_keyed == 0:
            return tuple(v for _hs, _hv, v in self.items.values())
        order = sorted(
            self.items.items(),
            key=lambda kv: (kv[1][0] is not None, _sortable(_unhash(kv[1][0])), kv[0]),
        )
        return tuple(v for _c, (_hs, _hv, v) in order)


def _sortable(v: Any) -> Any:
    if v is None:
        return 0
    return v


class TupleReducer(Reducer):
    name = "tuple"
    n_args = 2

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def make(self) -> Accumulator:
        return _TupleAcc(self.skip_nones)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.List_(arg_dtypes[0]) if arg_dtypes else dt.ANY_TUPLE


class _SortedTupleAcc(_MultisetAcc):
    def __init__(self, skip_nones: bool = False):
        super().__init__()
        self.skip_nones = skip_nones

    def insert(self, values: tuple) -> None:
        if self.skip_nones and values[0] is None:
            return
        super().insert(values)

    def retract(self, values: tuple) -> None:
        if self.skip_nones and values[0] is None:
            return
        super().retract(values)

    def insert_many(self, rows: Iterable[tuple]) -> None:
        super().insert_many(r for r in rows if not (self.skip_nones and r[0] is None))

    def retract_many(self, rows: Iterable[tuple]) -> None:
        super().retract_many(r for r in rows if not (self.skip_nones and r[0] is None))

    def value(self) -> tuple:
        out = []
        for k in sorted(self.items):
            out.extend([_unhash(k)] * self.items[k])
        return tuple(out)


class SortedTupleReducer(Reducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def make(self) -> Accumulator:
        return _SortedTupleAcc(self.skip_nones)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.List_(arg_dtypes[0]) if arg_dtypes else dt.ANY_TUPLE


class _NdarrayAcc(_TupleAcc):
    def value(self) -> np.ndarray:
        return np.array(super().value())


class NdarrayReducer(Reducer):
    name = "ndarray"
    n_args = 2

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def make(self) -> Accumulator:
        return _NdarrayAcc(self.skip_nones)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.Array(1, arg_dtypes[0] if arg_dtypes else dt.ANY)


class _AvgAcc(Accumulator):
    __slots__ = ("total", "n")

    def __init__(self) -> None:
        self.total = 0.0
        self.n = 0

    def insert(self, values: tuple) -> None:
        self.total = values[0] if self.n == 0 else self.total + values[0]
        self.n += 1

    def retract(self, values: tuple) -> None:
        self.total = self.total - values[0]
        self.n -= 1

    def value(self) -> Any:
        return self.total / self.n if self.n else None


class AvgReducer(Reducer):
    name = "avg"
    semigroup = True

    def make(self) -> Accumulator:
        return _AvgAcc()

    def make_state(self) -> ColumnarState:
        return _AvgState()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.FLOAT


class _EarliestAcc(Accumulator):
    """values = (value, seq): the engine passes a per-row sequence number
    that grows with every row the groupby takes, so the smallest live seq is
    the row that arrived first (the earliest commit).

    A retraction carries a NEW seq (the engine cannot know the original), so
    removal matches by value only, dropping the oldest occurrence."""

    __slots__ = ("items",)

    def __init__(self) -> None:
        self.items: list[tuple[int, Any]] = []

    def insert(self, values: tuple) -> None:
        self.items.append((values[1], values[0]))

    def retract(self, values: tuple) -> None:
        target = _hashable(values[0])
        for i, (_seq, v) in enumerate(self.items):
            if _hashable(v) == target:
                del self.items[i]
                return
        raise KeyError(f"retraction of absent value {values[0]!r}")

    def value(self) -> Any:
        return min(self.items, key=lambda sv: sv[0])[1] if self.items else None


class _LatestAcc(_EarliestAcc):
    def value(self) -> Any:
        return max(self.items, key=lambda sv: sv[0])[1] if self.items else None


class EarliestReducer(Reducer):
    name = "earliest"
    n_args = 2

    def make(self) -> Accumulator:
        return _EarliestAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class LatestReducer(Reducer):
    name = "latest"
    n_args = 2

    def make(self) -> Accumulator:
        return _LatestAcc()

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0]


class _UdfAcc(Accumulator):
    def __init__(self, combine: Callable[[list[tuple]], Any]):
        self.combine = combine
        self.rows: Counter = Counter()

    def insert(self, values: tuple) -> None:
        self.rows[_hashable(values)] += 1

    def retract(self, values: tuple) -> None:
        k = _hashable(values)
        self.rows[k] -= 1
        if self.rows[k] == 0:
            del self.rows[k]

    def insert_many(self, rows: Iterable[tuple]) -> None:
        self.rows.update(_hashable(r) for r in rows)

    def retract_many(self, rows: Iterable[tuple]) -> None:
        self.rows.subtract(_hashable(r) for r in rows)
        for k in [k for k, c in self.rows.items() if c == 0]:
            del self.rows[k]

    def value(self) -> Any:
        expanded: list[tuple] = []
        for k, c in self.rows.items():
            expanded.extend([_unhash(k)] * c)
        cols = tuple(np.array(col) for col in zip(*expanded)) if expanded else ()
        return self.combine(*cols)


class UdfReducer(Reducer):
    name = "udf_reducer"

    def __init__(self, fun: Callable, n_args: int = 1):
        self.fun = fun
        self.n_args = n_args

    def make(self) -> Accumulator:
        return _UdfAcc(self.fun)


def udf_reducer(reducer_cls: Any) -> Callable:
    """Wrap a ``BaseCustomAccumulator`` subclass into a reducer."""
    from pathway_tpu_torch.internals.custom_reducers import make_custom_reducer

    return make_custom_reducer(reducer_cls)


def stateful_many(combine_many: Callable) -> Callable:
    from pathway_tpu_torch.internals.custom_reducers import stateful_many as _sm

    return _sm(combine_many)


def stateful_single(combine_single: Callable) -> Callable:
    from pathway_tpu_torch.internals.custom_reducers import stateful_single as _ss

    return _ss(combine_single)


# -- public namespace (pw.reducers.*) --------------------------------------


class _ReducerNamespace:
    def count(self, *args: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(CountReducer(), *args)

    def sum(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(SumReducer(), arg)

    def min(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(MinReducer(), arg)

    def max(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(MaxReducer(), arg)

    def argmin(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(ArgMinReducer(), arg, _IdMarker())

    def argmax(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(ArgMaxReducer(), arg, _IdMarker())

    def unique(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(UniqueReducer(), arg)

    def any(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(AnyReducer(), arg)

    def avg(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(AvgReducer(), arg)

    def tuple(self, arg: Any, *, skip_nones: bool = False, sort_by: Any = None) -> expr.ReducerExpression:
        return expr.ReducerExpression(
            TupleReducer(skip_nones), arg, sort_by if sort_by is not None else None
        )

    def sorted_tuple(self, arg: Any, *, skip_nones: bool = False) -> expr.ReducerExpression:
        return expr.ReducerExpression(SortedTupleReducer(skip_nones), arg)

    def ndarray(self, arg: Any, *, skip_nones: bool = False, sort_by: Any = None) -> expr.ReducerExpression:
        return expr.ReducerExpression(
            NdarrayReducer(skip_nones), arg, sort_by if sort_by is not None else None
        )

    def earliest(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(EarliestReducer(), arg, _SeqMarker())

    def latest(self, arg: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(LatestReducer(), arg, _SeqMarker())

    def udf_reducer(self, reducer_cls: Any) -> Callable:
        return udf_reducer(reducer_cls)

    def stateful_many(self, combine: Callable) -> Callable:
        return stateful_many(combine)

    def stateful_single(self, combine: Callable) -> Callable:
        return stateful_single(combine)


class _IdMarker(expr.ColumnExpression):
    """Placeholder resolved by the engine to the row's id (pointer)."""


class _SeqMarker(expr.ColumnExpression):
    """Placeholder resolved by the engine to a monotone per-row sequence number."""


reducers = _ReducerNamespace()
