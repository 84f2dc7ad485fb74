"""Key index + multimap — the engine's slot allocators (port of ``pathway_tpu/engine/index.py``).

A ``KeyIndex`` maps a KEY_DTYPE batch to dense int64 *slots* in one call, so
every stateful operator (StateTable, groupby, joins) keeps its values in
slot-indexed columnar arrays. Both tables are the native module's
open-addressing C++ tables (``csrc/pathway_native.cc``) when it is built, and
dict-backed Python versions with the same slots and items otherwise
(``PATHWAY_TPU_DISABLE_NATIVE``, or no compiler).

Both pickle by content (their live items), so a pickled table loads into
either implementation.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pathway_tpu_torch import native as _native
from pathway_tpu_torch.internals.keys import KEY_DTYPE, key_bytes
from pathway_tpu_torch.native import I64P as _I64P
from pathway_tpu_torch.native import U8P as _U8P
from pathway_tpu_torch.native import U64P as _U64P


def _key_ptr(keys: np.ndarray) -> "tuple[np.ndarray, ctypes._Pointer]":
    """(contiguous keys to keep alive, their [hi, lo] uint64 pairs)."""
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"keys must be a KEY_DTYPE array, not {keys.dtype}")
    keys = np.ascontiguousarray(keys)
    return keys, keys.ctypes.data_as(_U64P)


class KeyIndex:
    """128-bit key -> dense slot map with slot recycling.

    Slots are assigned densely on insert and recycled on remove (the slot
    freed last is reused first), so callers can maintain parallel value arrays
    sized to ``slot_bound()``."""

    def __new__(cls, capacity_hint: int = 16):
        if cls is KeyIndex:
            cls = _NativeKeyIndex if _native.get_lib() is not None else _PyKeyIndex
        return super().__new__(cls)

    def __reduce__(self):
        keys, slots = self.items()
        return (_index_from_items, (keys, slots, self.slot_bound()))

    def __len__(self) -> int:
        raise NotImplementedError

    def slot_bound(self) -> int:
        raise NotImplementedError

    def upsert(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(slots, is_new) for a key batch; duplicates in one batch share a slot."""
        raise NotImplementedError

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def remove(self, keys: np.ndarray) -> np.ndarray:
        """Removed slot per key (-1 when absent); removed slots are recycled."""
        raise NotImplementedError

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _restore(self, keys: np.ndarray, slots: np.ndarray, next_slot: int) -> None:
        raise NotImplementedError


def _index_from_items(keys: np.ndarray, slots: np.ndarray, next_slot: int) -> KeyIndex:
    idx = KeyIndex(max(16, len(keys)))
    idx._restore(keys, slots, next_slot)
    return idx


class _NativeKeyIndex(KeyIndex):
    def __init__(self, capacity_hint: int = 16):
        self._lib = _native.require_lib()
        self._h = self._lib.pwtpu_idx_new(max(16, capacity_hint))

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.pwtpu_idx_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.pwtpu_idx_len(self._h))

    def slot_bound(self) -> int:
        return int(self._lib.pwtpu_idx_slot_bound(self._h))

    def upsert(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = len(keys)
        _keep, ptr = _key_ptr(keys)
        slots = np.empty(n, dtype=np.int64)
        is_new = np.empty(n, dtype=np.uint8)
        self._lib.pwtpu_idx_upsert(
            self._h, ptr, n, slots.ctypes.data_as(_I64P), is_new.ctypes.data_as(_U8P)
        )
        return slots, is_new.astype(bool)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        n = len(keys)
        _keep, ptr = _key_ptr(keys)
        slots = np.empty(n, dtype=np.int64)
        self._lib.pwtpu_idx_lookup(self._h, ptr, n, slots.ctypes.data_as(_I64P))
        return slots

    def remove(self, keys: np.ndarray) -> np.ndarray:
        n = len(keys)
        _keep, ptr = _key_ptr(keys)
        slots = np.empty(n, dtype=np.int64)
        self._lib.pwtpu_idx_remove(self._h, ptr, n, slots.ctypes.data_as(_I64P))
        return slots

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self)
        keys = np.zeros(n, dtype=KEY_DTYPE)
        slots = np.empty(n, dtype=np.int64)
        if n:
            self._lib.pwtpu_idx_items(
                self._h, keys.ctypes.data_as(_U64P), slots.ctypes.data_as(_I64P)
            )
        return keys, slots

    def _restore(self, keys: np.ndarray, slots: np.ndarray, next_slot: int) -> None:
        # slots index the caller's column arrays: they survive the round trip
        # exactly, recycled gaps included
        _keep, ptr = _key_ptr(keys)
        slots = np.ascontiguousarray(slots, dtype=np.int64)
        self._lib.pwtpu_idx_restore(
            self._h, ptr, slots.ctypes.data_as(_I64P), len(keys), next_slot
        )


class _PyKeyIndex(KeyIndex):
    """Dict-backed version with the native table's slots."""

    def __init__(self, capacity_hint: int = 16):
        self._map: dict[bytes, int] = {}
        self._free: list[int] = []
        self._next = 0

    def __len__(self) -> int:
        return len(self._map)

    def slot_bound(self) -> int:
        return self._next

    def upsert(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = len(keys)
        slots = np.empty(n, dtype=np.int64)
        is_new = np.zeros(n, dtype=bool)
        m = self._map
        for i, kb in enumerate(key_bytes(keys)):
            slot = m.get(kb)
            if slot is None:
                slot = self._free.pop() if self._free else self._alloc()
                m[kb] = slot
                is_new[i] = True
            slots[i] = slot
        return slots, is_new

    def _alloc(self) -> int:
        s = self._next
        self._next += 1
        return s

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        m = self._map
        out = np.empty(len(keys), dtype=np.int64)
        for i, kb in enumerate(key_bytes(keys)):
            out[i] = m.get(kb, -1)
        return out

    def remove(self, keys: np.ndarray) -> np.ndarray:
        out = np.empty(len(keys), dtype=np.int64)
        for i, kb in enumerate(key_bytes(keys)):
            slot = self._map.pop(kb, None)
            if slot is None:
                out[i] = -1
            else:
                out[i] = slot
                self._free.append(slot)
        return out

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self._map)
        keys = np.frombuffer(b"".join(self._map), dtype=KEY_DTYPE).copy()
        slots = np.fromiter(self._map.values(), dtype=np.int64, count=n)
        return keys, slots

    def _restore(self, keys: np.ndarray, slots: np.ndarray, next_slot: int) -> None:
        for kb, slot in zip(key_bytes(keys), slots.tolist()):
            self._map[kb] = slot
        self._next = next_slot
        used = set(slots.tolist())
        # the native table's free stack: the lowest gap is reused first
        self._free = [s for s in range(next_slot - 1, -1, -1) if s not in used]


class MultiMap:
    """128-bit key -> bag of int64 values (join-key -> row slots).

    Values are join-side row slots: dense, non-negative, each in at most one
    bag at a time (the native table links bags through arrays indexed by
    value, and a value under two keys would corrupt them). A bag lists its
    values last inserted first in the native table and in insertion order in
    the Python one: callers that need one order sort."""

    def __new__(cls):
        if cls is MultiMap:
            cls = _NativeMultiMap if _native.get_lib() is not None else _PyMultiMap
        return super().__new__(cls)

    def __reduce__(self):
        keys, values = self.items()
        return (_mm_from_items, (keys, values))

    def total(self) -> int:
        raise NotImplementedError

    def insert(self, keys: np.ndarray, values: np.ndarray) -> None:
        raise NotImplementedError

    def remove(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def counts(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        raise NotImplementedError

    def probe(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """CSR (offsets[n+1], matched_values) for a probe batch."""
        raise NotImplementedError

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


def _mm_from_items(keys: np.ndarray, values: np.ndarray) -> MultiMap:
    mm = MultiMap()
    if len(keys):
        mm.insert(keys, values)
    return mm


class _NativeMultiMap(MultiMap):
    def __init__(self):
        self._lib = _native.require_lib()
        self._h = self._lib.pwtpu_mm_new()

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.pwtpu_mm_free(h)
            self._h = None

    def total(self) -> int:
        return int(self._lib.pwtpu_mm_total(self._h))

    def insert(self, keys: np.ndarray, values: np.ndarray) -> None:
        _keep, ptr = _key_ptr(keys)
        values = np.ascontiguousarray(values, dtype=np.int64)
        if len(values) != len(keys) or (len(values) and values.min() < 0):
            raise ValueError("MultiMap values are non-negative slots, one per key")
        self._lib.pwtpu_mm_insert(self._h, ptr, values.ctypes.data_as(_I64P), len(keys))

    def remove(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        _keep, ptr = _key_ptr(keys)
        values = np.ascontiguousarray(values, dtype=np.int64)
        found = np.empty(len(keys), dtype=np.uint8)
        self._lib.pwtpu_mm_remove(
            self._h, ptr, values.ctypes.data_as(_I64P), len(keys), found.ctypes.data_as(_U8P)
        )
        return found.astype(bool)

    def counts(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        _keep, ptr = _key_ptr(keys)
        counts = np.empty(len(keys), dtype=np.int64)
        total = self._lib.pwtpu_mm_count(self._h, ptr, len(keys), counts.ctypes.data_as(_I64P))
        return counts, int(total)

    def probe(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        counts, total = self.counts(keys)
        offsets = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        values = np.empty(total, dtype=np.int64)
        if total:
            _keep, ptr = _key_ptr(keys)
            self._lib.pwtpu_mm_fill(self._h, ptr, len(keys), values.ctypes.data_as(_I64P))
        return offsets, values

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.total()
        keys = np.zeros(n, dtype=KEY_DTYPE)
        values = np.empty(n, dtype=np.int64)
        if n:
            self._lib.pwtpu_mm_items(
                self._h, keys.ctypes.data_as(_U64P), values.ctypes.data_as(_I64P)
            )
        return keys, values


class _PyMultiMap(MultiMap):
    def __init__(self):
        self._map: dict[bytes, list[int]] = {}

    def total(self) -> int:
        return sum(len(v) for v in self._map.values())

    def insert(self, keys: np.ndarray, values: np.ndarray) -> None:
        m = self._map
        for kb, v in zip(key_bytes(keys), np.asarray(values, dtype=np.int64).tolist()):
            m.setdefault(kb, []).append(v)

    def remove(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        out = np.zeros(len(keys), dtype=bool)
        m = self._map
        for i, (kb, v) in enumerate(
            zip(key_bytes(keys), np.asarray(values, dtype=np.int64).tolist())
        ):
            bag = m.get(kb)
            if bag is None:
                continue
            try:
                idx = bag.index(v)
            except ValueError:
                continue
            bag[idx] = bag[-1]
            bag.pop()
            if not bag:
                del m[kb]
            out[i] = True
        return out

    def counts(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        m = self._map
        counts = np.empty(len(keys), dtype=np.int64)
        total = 0
        for i, kb in enumerate(key_bytes(keys)):
            c = len(m.get(kb, ()))
            counts[i] = c
            total += c
        return counts, total

    def probe(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        counts, total = self.counts(keys)
        offsets = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        values = np.empty(total, dtype=np.int64)
        w = 0
        m = self._map
        for kb in key_bytes(keys):
            bag = m.get(kb)
            if bag:
                values[w : w + len(bag)] = bag
                w += len(bag)
        return offsets, values

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.total()
        keys = np.zeros(n, dtype=KEY_DTYPE)
        values = np.empty(n, dtype=np.int64)
        j = 0
        for kb, bag in self._map.items():
            k = np.frombuffer(kb, dtype=KEY_DTYPE)[0]
            for v in bag:
                keys[j] = k
                values[j] = v
                j += 1
        return keys, values
