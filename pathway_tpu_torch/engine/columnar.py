"""Columnar keyed state + update-stream deltas (port of ``pathway_tpu/engine/columnar.py``).

A table's materialized state is struct-of-arrays keyed by 128-bit keys; each
commit moves a ``Delta`` (keys, +1/-1 diffs, column values) through the
operator graph. Columns are host numpy arrays; device work (embeddings, the
index) happens inside the operators that own it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Sequence

import numpy as np

from pathway_tpu_torch.internals.keys import KEY_DTYPE, keys_to_pointers


class Error:
    """Singleton poisoned value: a cell whose computation failed."""

    _instance: "Error | None" = None

    def __new__(cls) -> "Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        # a poisoned cell must never silently coerce to True (filters would keep
        # rows whose predicate ERRORED — e.g. NULL comparisons); consumers that
        # can absorb Error check isinstance explicitly
        raise TypeError("Error value has no truth value")


ERROR = Error()


def empty_keys() -> np.ndarray:
    return np.empty(0, dtype=KEY_DTYPE)


def objarray(values: Sequence[Any]) -> np.ndarray:
    """1-D object array; safe for ndarray-valued cells (``np.array(list, dtype=object)``
    would silently build a 2-D array when elements are equal-length ndarrays)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


@dataclass
class Delta:
    """A batch of row updates: parallel arrays of key, diff (+1 insert / -1 retract), values.

    Retraction rows carry the values being retracted so downstream stateful operators
    (groupby, joins) can subtract without a lookup.

    ``neu`` marks a delta emitted at an odd ("neu") time: the second phase of a
    commit, which moves the *forgetting* retractions of the time-threshold
    operators. Downstream operators process it normally (their state shrinks),
    but ``_filter_out_results_of_forgetting`` drops it, so results already
    delivered stay.
    """

    keys: np.ndarray  # (n,) KEY_DTYPE
    diffs: np.ndarray  # (n,) int64 in {+1, -1}
    columns: Dict[str, np.ndarray]  # each (n,)
    neu: bool = False

    def __post_init__(self) -> None:
        n = len(self.keys)
        assert len(self.diffs) == n
        for name, col in self.columns.items():
            assert len(col) == n, f"column {name!r} length {len(col)} != {n}"

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def column_names(self) -> list[str]:
        return list(self.columns)

    @staticmethod
    def empty(column_names: Iterable[str]) -> "Delta":
        return Delta(
            keys=empty_keys(),
            diffs=np.empty(0, dtype=np.int64),
            columns={name: np.empty(0, dtype=object) for name in column_names},
        )

    def select(self, mask: np.ndarray) -> "Delta":
        return Delta(
            keys=self.keys[mask],
            diffs=self.diffs[mask],
            columns={name: col[mask] for name, col in self.columns.items()},
            neu=self.neu,
        )

    def with_columns(self, columns: Dict[str, np.ndarray]) -> "Delta":
        return Delta(keys=self.keys, diffs=self.diffs, columns=columns, neu=self.neu)

    def negated(self) -> "Delta":
        return Delta(keys=self.keys, diffs=-self.diffs, columns=self.columns, neu=self.neu)

    @staticmethod
    def concat(deltas: Sequence["Delta"], column_names: Sequence[str]) -> "Delta":
        deltas = [d for d in deltas if len(d)]
        if not deltas:
            return Delta.empty(column_names)
        neu = any(d.neu for d in deltas)
        if len(deltas) == 1:
            d = deltas[0]
            return Delta(d.keys, d.diffs, {n: d.columns[n] for n in column_names}, neu=neu)
        keys = np.concatenate([d.keys for d in deltas])
        diffs = np.concatenate([d.diffs for d in deltas])
        columns = {}
        for name in column_names:
            parts = [d.columns[name] for d in deltas]
            if any(p.dtype == object for p in parts):
                merged = np.empty(sum(len(p) for p in parts), dtype=object)
                offset = 0
                for p in parts:
                    merged[offset : offset + len(p)] = p
                    offset += len(p)
                columns[name] = merged
            else:
                columns[name] = np.concatenate(parts)
        return Delta(keys, diffs, columns, neu=neu)

    def consolidated(self) -> "Delta":
        """Cancel matching (+1, -1) rows with identical key+values within the batch.

        Rows are identified by (key, XXH3-128 signature of the values): the
        signatures hash in one batch (``keys_from_values``, natively where the
        values allow) and rows group through a ``KeyIndex`` in first-appearance
        order (the DD ``consolidate`` counterpart at commit granularity).
        A single-signed batch (pure inserts or pure retracts) can never cancel and
        passes through untouched."""
        if len(self) == 0:
            return self
        if (self.diffs > 0).all() or (self.diffs < 0).all():
            return self  # cancellation needs opposite signs
        from pathway_tpu_torch.engine.index import KeyIndex
        from pathway_tpu_torch.internals.keys import keys_from_values

        combo = np.zeros(len(self), dtype=KEY_DTYPE)
        combo["hi"], combo["lo"] = self.keys["hi"], self.keys["lo"]
        if self.columns:
            # mix the row key into the values' signature (both uniform already):
            # the 128 bits identify (key, values) rows
            sig = keys_from_values(list(self.columns.values()))
            combo["hi"] = self.keys["hi"] * np.uint64(0x9E3779B97F4A7C15) + sig["hi"]
            combo["lo"] = self.keys["lo"] * np.uint64(0xC2B2AE3D27D4EB4F) + sig["lo"]
        grouper = KeyIndex(len(self))
        inverse, is_new = grouper.upsert(combo)
        n_groups = grouper.slot_bound()
        if n_groups == len(self):
            return self  # all rows distinct: nothing cancels
        net = np.zeros(n_groups, dtype=np.int64)
        np.add.at(net, inverse, self.diffs)
        # a fresh index hands out slots in first-appearance order, so the rows
        # flagged is_new ARE the per-slot first occurrences, already slot-ordered
        first_idx = np.nonzero(is_new)[0]
        keep = np.nonzero(net != 0)[0]
        idx = first_idx[keep]
        out = self.select(idx)
        out.diffs = net[keep]
        # expand |diff|>1 into repeated unit rows to preserve row-per-key invariants downstream
        if np.any(np.abs(out.diffs) > 1):
            reps = np.abs(out.diffs).astype(np.int64)
            signs = np.sign(out.diffs)
            idx2 = np.repeat(np.arange(len(out.diffs)), reps)
            out = Delta(
                keys=out.keys[idx2],
                diffs=np.repeat(signs, reps),
                columns={n: c[idx2] for n, c in out.columns.items()},
                neu=self.neu,
            )
        return out


def grow_column(col: np.ndarray, new_cap: int) -> np.ndarray:
    """Resize a slot-indexed value array, preserving dtype and contents."""
    out = np.empty(new_cap, dtype=col.dtype)
    out[: len(col)] = col
    if col.dtype == object:
        out[len(col) :] = None
    return out


def adopt_dtype(storage: np.ndarray, incoming: np.ndarray) -> np.ndarray:
    """Converge a slot column's dtype with an incoming delta column's dtype.

    Columns are typed by what actually flows through them (schema-driven upstream);
    a dtype conflict across commits demotes the storage to object — correctness
    over speed for heterogeneous streams."""
    if storage.dtype == incoming.dtype or incoming.dtype == object:
        if storage.dtype != object and incoming.dtype == object:
            return storage.astype(object)
        return storage
    if storage.dtype == object:
        return storage
    promoted = np.promote_types(storage.dtype, incoming.dtype)
    if promoted == storage.dtype:
        return storage
    try:
        return storage.astype(promoted)
    except (TypeError, ValueError):
        return storage.astype(object)


def set_cells(storage: np.ndarray, slots: Any, values: np.ndarray) -> np.ndarray:
    """Write ``values`` into ``storage[slots]``, converging dtypes; returns storage
    (possibly re-typed — callers must re-assign)."""
    storage = adopt_dtype(storage, np.asarray(values))
    try:
        storage[slots] = values
    except (TypeError, ValueError):
        storage = storage.astype(object)
        storage[slots] = values
    return storage


class StateTable:
    """Materialized keyed state: the arrangement replacement.

    Struct-of-arrays with SCHEMA-DRIVEN dtypes: each value column keeps the dtype of
    the deltas flowing through it (int64/float64/bool typed arrays; object only for
    strings/Json/ndarray cells), so downstream kernels gather typed batches without
    re-boxing. The key->slot map is a ``KeyIndex`` (``engine/index.py``): the
    native open-addressing table, so ``apply`` / ``lookup`` are O(batch) C
    calls, not per-row Python.
    """

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        from pathway_tpu_torch.engine.index import KeyIndex

        self._index = KeyIndex()
        self._capacity = 0
        self._keys = empty_keys()
        self._columns: Dict[str, np.ndarray] = {
            name: np.empty(0, dtype=object) for name in self.column_names
        }
        self._valid = np.empty(0, dtype=bool)

    def __len__(self) -> int:
        return len(self._index)

    def _ensure_capacity(self) -> None:
        bound = self._index.slot_bound()
        if bound <= self._capacity:
            return
        new_cap = max(16, self._capacity * 2, bound)
        keys = np.zeros(new_cap, dtype=KEY_DTYPE)
        keys[: self._capacity] = self._keys
        self._keys = keys
        valid = np.zeros(new_cap, dtype=bool)
        valid[: self._capacity] = self._valid
        self._valid = valid
        for name in self.column_names:
            self._columns[name] = grow_column(self._columns[name], new_cap)
        self._capacity = new_cap

    def apply(self, delta: Delta) -> None:
        n = len(delta)
        if n == 0:
            return
        retract = delta.diffs < 0
        ret_rows = np.nonzero(retract)[0]
        if len(ret_rows):
            slots = self._index.remove(delta.keys[ret_rows])
            missing = slots < 0
            if missing.any():
                i = int(ret_rows[np.nonzero(missing)[0][0]])
                raise KeyError(f"retraction of absent key {delta.keys[i]!r}")
            self._valid[slots] = False
            for name in self.column_names:
                col = self._columns[name]
                if col.dtype == object:
                    col[slots] = None  # release refs
        ins_rows = np.nonzero(~retract)[0]
        if len(ins_rows):
            if self._capacity == 0:
                # first allocation: column dtypes come from the first delta through
                # (schema-driven upstream), making the typed fast paths live
                for name in self.column_names:
                    self._columns[name] = np.empty(0, dtype=delta.columns[name].dtype)
            slots, is_new = self._index.upsert(delta.keys[ins_rows])
            if not is_new.all():
                i = int(ins_rows[np.nonzero(~is_new)[0][0]])
                raise KeyError(
                    f"duplicate key {keys_to_pointers(delta.keys[i:i+1])[0]!r}"
                )
            self._ensure_capacity()
            self._keys[slots] = delta.keys[ins_rows]
            self._valid[slots] = True
            for name in self.column_names:
                incoming = delta.columns[name]
                self._columns[name] = col = adopt_dtype(self._columns[name], incoming)
                try:
                    col[slots] = incoming[ins_rows]
                except (TypeError, ValueError):
                    # incompatible cell values for the typed column: demote to object
                    self._columns[name] = col = col.astype(object)
                    col[slots] = incoming[ins_rows]

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Row slots for keys; -1 when absent."""
        return self._index.lookup(keys)

    def gather(self, name: str, slots: np.ndarray) -> np.ndarray:
        """Typed value batch for the given slots (callers mask absent rows)."""
        return self._columns[name][slots]

    def get_row(self, key_b: bytes) -> dict[str, Any] | None:
        slot = int(self._index.lookup(np.frombuffer(key_b, dtype=KEY_DTYPE))[0])
        if slot < 0:
            return None
        return {name: self._columns[name][slot] for name in self.column_names}

    def snapshot(self) -> Delta:
        """The current rows as an insertion delta."""
        slots = np.nonzero(self._valid)[0]
        return Delta(
            keys=self._keys[slots].copy(),
            diffs=np.ones(len(slots), dtype=np.int64),
            columns={name: self._columns[name][slots].copy() for name in self.column_names},
        )

    def state_blob(self) -> bytes:
        """A pickled snapshot of the live rows, for operator checkpoints."""
        import pickle

        snap = self.snapshot()
        return pickle.dumps(
            (snap.keys, snap.diffs, snap.columns), protocol=pickle.HIGHEST_PROTOCOL
        )

    def load_state_blob(self, blob: bytes) -> None:
        import pickle

        keys, diffs, columns = pickle.loads(blob)
        self.__init__(self.column_names)
        self.apply(Delta(keys, diffs, columns))
