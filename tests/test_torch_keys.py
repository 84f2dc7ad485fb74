"""The port's keys against the reference's, bit for bit.

The port hashes with its own XXH3-128 (``internals/xxh3.py``): the one-message
path and the many-rows numpy path must equal ``xxhash.xxh3_128_digest`` for
every input length from 0 to 300 (0, 1-3, 4-8, 9-16, 17-128, 129-240 and the
long path), and a few lengths past one 1024-byte block. Every key the
engine derives (``pointer_from``, the keys of ``flatten`` and
``concat_reindex``, auto keys, ``keys_from_values``) must equal the
reference's exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import xxhash

import pathway_tpu.internals.keys as ref_keys
import pathway_tpu_torch.internals.keys as keys
from pathway_tpu.engine.columnar import objarray
from pathway_tpu.internals.json import Json as RefJson
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.xxh3 import xxh3_128_digest, xxh3_128_rows

LENGTHS = list(range(0, 301)) + [1023, 1024, 1025, 2048, 2049, 4100]


def _messages(n: int, count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(count)]


@pytest.mark.parametrize("n", LENGTHS)
def test_xxh3_128_equals_xxhash_for_every_length(n):
    msgs = _messages(n, 4, n)
    for m in msgs:
        assert xxh3_128_digest(m) == xxhash.xxh3_128_digest(m)
    high, low = xxh3_128_rows(np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(4, n))
    for i, m in enumerate(msgs):
        digest = int(high[i]).to_bytes(8, "big") + int(low[i]).to_bytes(8, "big")
        assert digest == xxhash.xxh3_128_digest(m)


VALUES = [
    None, 0, 1, -5, 2**63 - 1, -(2**63), 2**70, True, False, 3.5, -0.0, float("inf"),
    "", "abc", "ünïcode", b"", b"xy", (1, "a"), [2, 3.5], (), {"a": 1, "b": [1, 2]},
    frozenset({1, 2}), np.int64(7), np.float32(0.25), np.arange(3, dtype=np.int32),
]


def _as_ref(v):
    if isinstance(v, keys.Pointer):
        return ref_keys.Pointer(v.hi, v.lo)
    if isinstance(v, Json):
        return RefJson(v.value)
    if isinstance(v, tuple):
        return tuple(_as_ref(x) for x in v)
    return v


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_pointer_from_equals_the_reference(i):
    v = VALUES[i]
    for parts in ((v,), (v, "x", 3), ("tag", v, keys.Pointer(5, 6))):
        want = ref_keys.pointer_from(*_as_ref(parts)).as_int()
        assert keys.pointer_from(*parts).as_int() == want


def test_json_and_nested_values_key_like_the_reference():
    meta = Json({"path": "/a/b.txt", "n": 3, "tags": ["x", "y"]})
    assert keys.pointer_from(meta, 1).as_int() == ref_keys.pointer_from(_as_ref(meta), 1).as_int()
    rows = [("p%d" % i, Json({"i": i})) for i in range(70)]
    want = ref_keys.keys_from_values(
        [objarray([r[0] for r in rows]), objarray([_as_ref(r[1]) for r in rows])]
    )
    got = keys.keys_from_rows(rows)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 63, 64, 500])
def test_batch_keys_equal_the_reference(n):
    rng = np.random.default_rng(n)
    strs = np.array([f"/doc/{i}/" + "x" * int(rng.integers(0, 40)) for i in range(n)], dtype=object)
    floats = rng.normal(size=n)
    ints = rng.integers(-(10**12), 10**12, n)
    mask = rng.random(n) < 0.5
    for cols, masks in (
        ([strs], None),
        ([ints], None),
        ([strs, floats], None),
        ([ints, strs], [mask, None]),
        ([strs.astype(object)], [mask]),
    ):
        assert np.array_equal(keys.keys_from_values(cols, masks), ref_keys.keys_from_values(cols, masks))
    assert np.array_equal(keys.sequential_keys(17, n), ref_keys.sequential_keys(17, n))


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_flatten_and_concat_reindex_keys_equal_the_reference(n):
    rng = np.random.default_rng(n)
    parents = ref_keys.sequential_keys(int(rng.integers(0, 1000)), n)
    items = rng.integers(0, 300, n)
    want = ref_keys.pointers_to_keys(
        [ref_keys.pointer_from(p, int(j), "flatten") for p, j in zip(ref_keys.keys_to_pointers(parents), items)]
    )
    assert np.array_equal(keys.derived_keys(parents, items, "flatten"), want)
    for index in (0, 1, 5):
        want = ref_keys.pointers_to_keys(
            [ref_keys.pointer_from(p, index) for p in ref_keys.keys_to_pointers(parents)]
        )
        assert np.array_equal(keys.reindexed_keys(parents, index), want)


def test_join_keys_equal_the_reference():
    rng = np.random.default_rng(3)
    a = ref_keys.sequential_keys(0, 200)
    b = ref_keys.sequential_keys(5000, 200)
    lm, rm = rng.random(200) < 0.7, rng.random(200) < 0.7
    assert np.array_equal(keys.combine_keys(a, b, lm, rm), ref_keys.combine_keys(a, b, lm, rm))
