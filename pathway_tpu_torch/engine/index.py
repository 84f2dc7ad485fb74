"""Key index + multimap — the engine's slot allocators (port of ``pathway_tpu/engine/index.py``).

A ``KeyIndex`` maps a KEY_DTYPE batch to dense int64 *slots*, so every
stateful operator (StateTable, groupby, joins) keeps its values in
slot-indexed columnar arrays. The port keeps the reference's dict-backed
implementations (its native C++ tables are not ported).
"""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.internals.keys import KEY_DTYPE, key_bytes


class KeyIndex:
    """128-bit key -> dense slot map with slot recycling.

    Slots are assigned densely on insert and recycled on remove, so callers can
    maintain parallel value arrays sized to ``slot_bound()``."""

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
        keys = np.zeros(n, dtype=KEY_DTYPE)
        slots = np.empty(n, dtype=np.int64)
        for i, (kb, slot) in enumerate(self._map.items()):
            keys[i] = np.frombuffer(kb, dtype=KEY_DTYPE)[0]
            slots[i] = slot
        return keys, slots


class MultiMap:
    """128-bit key -> bag of int64 values (join-key -> row slots).

    Values are join-side row slots: dense, non-negative, each in at most one
    bag at a time."""

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
