"""The port's native host module against the reference's, on the CPU.

``pathway_tpu_torch/csrc/pathway_native.cc`` is the port's own copy of the
reference's native module, with its own XXH3-128 in place of ``xxhash.h``.
Held here, on inputs made from a seed:

- its XXH3-128 against the port's Python and numpy XXH3 (``internals/xxh3.py``)
  at every length from 0 to 1,100 and at 4,096 bytes, bit for bit;
- ``keys_from_values`` for every column kind, ``sequential_keys`` and
  ``combine_keys`` against the reference's, bit for bit, and against the
  port's own Python path;
- seeded runs of upserts, lookups, removes and restores on ``KeyIndex`` and
  ``MultiMap``: the port's native and Python tables and the reference's
  native table give the same slots, counts and items, and survive pickling;
- the fused ``hash_upsert`` against the two-step path;
- ``split_dsv`` / ``parse_dsv_rows`` against the ``csv`` module and against
  the reference's, on the reference's edge cases.
"""

from __future__ import annotations

import csv
import io
import pickle

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import pathway_tpu.engine.index as ref_index
import pathway_tpu.internals.keys as ref_keys
import pathway_tpu.native as ref_native
import pathway_tpu_torch.internals.keys as keys
from pathway_tpu_torch import native
from pathway_tpu_torch.engine import index
from pathway_tpu_torch.engine.columnar import ERROR
from pathway_tpu_torch.internals.xxh3 import xxh3_128, xxh3_128_rows

# the reference's library loads once per process, before any test below sets
# PATHWAY_TPU_DISABLE_NATIVE for the port
REF_LIB = ref_native.get_lib()


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")


def test_the_library_builds_into_the_build_dir():
    lib = native.require_lib()
    assert lib is native.get_lib()
    path = native.BUILD_INFO["path"]
    assert path == native.lib_path()
    assert path.startswith(native.BUILD_DIR + "/") and path.endswith(".so")
    assert native.BUILD_INFO["python_h"]
    assert native.BUILD_ERROR is None


def test_disable_switch_turns_every_native_path_off(no_native):
    assert native.get_lib() is None
    with pytest.raises(RuntimeError, match="PATHWAY_TPU_DISABLE_NATIVE"):
        native.require_lib()
    assert isinstance(index.KeyIndex(), index._PyKeyIndex)
    assert isinstance(index.MultiMap(), index._PyMultiMap)
    assert native.split_dsv(b"a,b\n") is None


BANDS = [(0, 1), (1, 4), (4, 9), (9, 17), (17, 129), (129, 241), (241, 600), (600, 1101),
         (4096, 4097)]


@pytest.mark.parametrize("lo,hi", BANDS, ids=[f"{a}-{b - 1}" for a, b in BANDS])
def test_c_xxh3_128_equals_the_python_xxh3(lo, hi):
    """``pwtpu_hash_serialized`` over messages of every length in the band
    (the keys are the digest's byte-swapped halves) against the Python
    one-message hash and the numpy many-rows hash."""
    rng = np.random.default_rng(lo)
    lib = native.require_lib()
    for n in range(lo, hi):
        msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(3)]
        offsets = np.arange(4, dtype=np.uint64) * np.uint64(n)
        got = keys._native_hash_serialized(b"".join(msgs), offsets, 3, lib)
        high, low = xxh3_128_rows(np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(3, n))
        for i, m in enumerate(msgs):
            want = tuple(int.from_bytes(x.to_bytes(8, "little"), "big") for x in xxh3_128(m))
            assert (int(got["hi"][i]), int(got["lo"][i])) == want, n
            assert (int(high[i]), int(low[i])) == xxh3_128(m), n


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _columns(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(2**40), 2**40, n)
    if kind == "int64_pair":
        return [ints.astype(np.int64), rng.integers(0, 9, n).astype(np.int64)]
    if kind == "float64":
        return [rng.normal(size=n)]
    if kind == "float32":
        return [rng.normal(size=n).astype(np.float32)]
    if kind == "bool":
        return [rng.integers(0, 2, n).astype(bool)]
    if kind == "key128":
        k = np.empty(n, dtype=keys.KEY_DTYPE)
        k["hi"] = rng.integers(0, 2**63, n, dtype=np.uint64)
        k["lo"] = rng.integers(0, 2**63, n, dtype=np.uint64)
        return [k]
    if kind == "uint64_overflow":
        return [np.array([2**63 + 5] * n, dtype=np.uint64)]
    if kind == "str":
        return [_obj([f"w{i}-{'é' * (i % 3)}" for i in rng.integers(0, 50, n)])]
    if kind == "obj_int":
        return [_obj([int(v) for v in ints])]
    if kind == "obj_np_int":
        return [_obj([np.int32(v % 1000) for v in ints])]
    if kind == "obj_float":
        return [_obj([float(v) / 7 for v in ints])]
    if kind == "obj_none":
        return [_obj([None if v % 3 == 0 else f"s{v}" for v in ints])]
    if kind == "obj_bool":
        return [_obj([bool(v % 2) for v in ints])]
    if kind == "obj_tuple":  # not serialised natively: the whole batch hashes in Python
        return [_obj([(int(v), "t") if v % 5 == 0 else f"x{v}" for v in ints])]
    if kind == "obj_bigint":
        return [_obj([2**100 if v % 7 == 0 else int(v) for v in ints])]
    if kind == "mixed":
        return [
            _obj([[None, 1, 2.5, "s", True, np.int64(3)][v % 6] for v in ints]),
            ints.astype(np.int64),
            rng.normal(size=n),
        ]
    raise ValueError(kind)


KINDS = ["int64_pair", "float64", "float32", "bool", "key128", "uint64_overflow", "str",
         "obj_int", "obj_np_int", "obj_float", "obj_none", "obj_bool", "obj_tuple",
         "obj_bigint", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_keys_from_values_equal_the_reference_bit_for_bit(kind):
    for n, seed in ((1, 1), (70, 2), (3000, 3)):
        cols = _columns(kind, n, seed)
        got = keys.keys_from_values(cols)
        assert got.tobytes() == ref_keys.keys_from_values(cols).tobytes(), (kind, n)
        assert got.tobytes() == keys._python_keys(cols, n).tobytes(), (kind, n)


@pytest.mark.parametrize("kind", ["str", "mixed", "obj_int", "float64"])
def test_masked_keys_equal_the_reference(kind):
    cols = _columns(kind, 500, 4)
    rng = np.random.default_rng(5)
    masks = [rng.integers(0, 2, 500).astype(bool) for _ in cols]
    got = keys.keys_from_values(cols, masks)
    assert got.tobytes() == ref_keys.keys_from_values(cols, masks).tobytes()
    assert got.tobytes() == keys._python_keys(cols, 500, masks).tobytes()


@pytest.mark.parametrize("start,count", [(0, 1), (5, 100), (-40, 3000), (2**40, 257)])
def test_sequential_keys_equal_the_reference(start, count, monkeypatch):
    got = keys.sequential_keys(start, count)
    assert got.tobytes() == ref_keys.sequential_keys(start, count).tobytes()
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    assert keys.sequential_keys(start, count).tobytes() == got.tobytes()


@pytest.mark.parametrize("n", [1, 63, 64, 2000])
def test_combine_keys_equal_the_reference(n, monkeypatch):
    rng = np.random.default_rng(n)
    lk, rk = _columns("key128", n, n)[0], _columns("key128", n, n + 1)[0]
    lm, rm = rng.integers(0, 2, n).astype(bool), rng.integers(0, 2, n).astype(bool)
    got = keys.combine_keys(lk, rk, lm, rm)
    assert got.tobytes() == ref_keys.combine_keys(lk, rk, lm, rm).tobytes()
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    assert keys.combine_keys(lk, rk, lm, rm).tobytes() == got.tobytes()


def test_derived_and_row_keys_are_the_same_natively_and_in_numpy(monkeypatch):
    parents = keys.sequential_keys(0, 300)
    idx = np.arange(300, dtype=np.int64)
    rows = [(f"/f/{i}.txt", i, "fs") for i in range(300)] + [("a",), (7,), ()]
    native_out = (
        keys.derived_keys(parents, idx, "flatten"),
        keys.reindexed_keys(parents, 3),
        keys.keys_from_rows(rows),
    )
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    numpy_out = (
        keys.derived_keys(parents, idx, "flatten"),
        keys.reindexed_keys(parents, 3),
        keys.keys_from_rows(rows),
    )
    for a, b in zip(native_out, numpy_out):
        assert a.tobytes() == b.tobytes()
    want = ref_keys.pointers_to_keys([ref_keys.pointer_from(*r) for r in rows])
    assert native_out[2].tobytes() == want.tobytes()


# -- KeyIndex / MultiMap -----------------------------------------------------------


def _key_pool(n: int, seed: int) -> np.ndarray:
    return _columns("key128", n, seed)[0]


def _index_ops(seed: int, steps: int = 60):
    """A seeded run of (op, keys) batches: upserts with duplicates, lookups of
    present and absent keys, removes (some absent), so slots recycle."""
    rng = np.random.default_rng(seed)
    pool = _key_pool(400, seed)
    ops = []
    for _ in range(steps):
        op = rng.choice(["upsert", "upsert", "lookup", "remove"])
        batch = pool[rng.integers(0, len(pool), int(rng.integers(1, 80)))]
        ops.append((str(op), batch))
    return ops


def _drive_index(idx, ops) -> list:
    out = []
    for op, batch in ops:
        if op == "upsert":
            slots, is_new = idx.upsert(batch)
            out.append((op, slots.tolist(), is_new.tolist()))
        elif op == "lookup":
            out.append((op, idx.lookup(batch).tolist()))
        else:
            out.append((op, idx.remove(batch).tolist()))
        out.append(("len", len(idx), idx.slot_bound()))
    return out


def _sorted_items(items) -> list:
    k, v = items
    return sorted(zip(k["hi"].tolist(), k["lo"].tolist(), v.tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_key_index_slots_equal_the_reference_native_and_python(seed):
    ops = _index_ops(seed)
    port_native = index.KeyIndex()
    port_py = index._PyKeyIndex()
    ref = ref_index.KeyIndex()
    assert isinstance(port_native, index._NativeKeyIndex)
    assert isinstance(ref, ref_index._NativeKeyIndex)
    want = _drive_index(ref, ops)
    assert _drive_index(port_native, ops) == want
    assert _drive_index(port_py, ops) == want
    items = _sorted_items(ref.items())
    assert _sorted_items(port_native.items()) == items
    assert _sorted_items(port_py.items()) == items


@pytest.mark.parametrize("seed", [0, 1])
def test_key_index_pickles_and_keeps_handing_out_the_same_slots(seed):
    ops = _index_ops(seed)
    tables = [index.KeyIndex(), index._PyKeyIndex(), ref_index.KeyIndex()]
    for t in tables:
        _drive_index(t, ops[:40])
    restored = [pickle.loads(pickle.dumps(t)) for t in tables]
    assert isinstance(restored[0], index._NativeKeyIndex)
    # the Python table restores with the native table's free stack
    py = index._PyKeyIndex()
    py._restore(*tables[0].items(), tables[0].slot_bound())
    restored.append(py)
    tables.append(tables[0])
    for a, b in zip(tables, restored):
        assert _sorted_items(a.items()) == _sorted_items(b.items())
        assert a.slot_bound() == b.slot_bound()
    # after a restore every table reuses the same free slots
    runs = [_drive_index(t, ops[40:]) for t in restored]
    assert runs[0] == runs[1] == runs[2] == runs[3]


def test_key_index_grows_and_purges_tombstones():
    idx = index.KeyIndex(16)
    pool = _key_pool(20000, 9)
    slots, is_new = idx.upsert(pool)
    assert is_new.all() and sorted(slots.tolist()) == list(range(20000))
    for round_ in range(5):  # constant live count under churn
        idx.remove(pool[:10000])
        s2, new2 = idx.upsert(pool[:10000])
        assert new2.all() and len(idx) == 20000 and idx.slot_bound() == 20000
    assert (idx.lookup(pool) >= 0).all()


def _mm_ops(seed: int, steps: int = 80):
    """Seeded insert / remove batches over unique values (row slots)."""
    rng = np.random.default_rng(seed)
    jks = _key_pool(30, seed)
    where: dict = {}
    ops = []
    free = list(range(300))
    for _ in range(steps):
        if where and rng.random() < 0.4:
            vals = rng.choice(sorted(where), size=min(len(where), int(rng.integers(1, 20))),
                              replace=False)
            # some removes name the wrong bag: they must not remove anything
            ks = np.array([jks[where[v]] if rng.random() < 0.8 else jks[0] for v in vals],
                          dtype=keys.KEY_DTYPE)
            ops.append(("remove", ks, np.asarray(vals, dtype=np.int64)))
            for v, k in zip(vals.tolist(), ks):
                if k == jks[where[v]]:
                    del where[v]
                    free.append(v)
        else:
            m = min(len(free), int(rng.integers(1, 20)))
            vals = [free.pop(int(rng.integers(0, len(free)))) for _ in range(m)]
            ki = rng.integers(0, len(jks), m)
            for v, k in zip(vals, ki.tolist()):
                where[v] = k
            ops.append(("insert", jks[ki], np.asarray(vals, dtype=np.int64)))
    return ops, jks


def _drive_mm(mm, ops, probe_keys) -> list:
    out = []
    for op, ks, vals in ops:
        if op == "insert":
            mm.insert(ks, vals)
        else:
            out.append(mm.remove(ks, vals).tolist())
        counts, total = mm.counts(probe_keys)
        offsets, matched = mm.probe(probe_keys)
        bags = [sorted(matched[offsets[i] : offsets[i + 1]].tolist()) for i in range(len(probe_keys))]
        out.append((counts.tolist(), total, offsets.tolist(), bags))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multimap_counts_and_bags_equal_the_reference(seed):
    ops, jks = _mm_ops(seed)
    probe = np.concatenate([jks, _key_pool(5, 99)])
    ref = ref_index.MultiMap()
    port_native, port_py = index.MultiMap(), index._PyMultiMap()
    assert isinstance(port_native, index._NativeMultiMap)
    want = _drive_mm(ref, ops, probe)
    assert _drive_mm(port_native, ops, probe) == want
    assert _drive_mm(port_py, ops, probe) == want
    # the native tables list each bag in the same (newest first) order
    assert port_native.probe(probe)[1].tolist() == ref.probe(probe)[1].tolist()
    items = _sorted_items(ref.items())
    assert _sorted_items(port_native.items()) == items == _sorted_items(port_py.items())
    for mm in (port_native, port_py):
        back = pickle.loads(pickle.dumps(mm))
        assert _sorted_items(back.items()) == items
        assert back.total() == mm.total()


# -- fused hash + upsert -----------------------------------------------------------


def test_hash_upsert_fused_matches_two_step():
    rng = np.random.default_rng(0)
    words = _obj([f"w{i % 500}" for i in range(5000)])
    nums = rng.integers(0, 100, 5000).astype(np.int64)
    idx_a, idx_b, ref = index.KeyIndex(), index.KeyIndex(), ref_index.KeyIndex()
    keys_f, slots_f, new_f = keys.hash_upsert(idx_a, [words, nums])
    keys_t = keys.keys_from_values([words, nums])
    slots_t, new_t = idx_b.upsert(keys_t)
    keys_r, slots_r, new_r = ref_keys.hash_upsert(ref, [words, nums])
    assert keys_f.tobytes() == keys_t.tobytes() == keys_r.tobytes()
    assert slots_f.tolist() == slots_t.tolist() == slots_r.tolist()
    assert new_f.tolist() == new_t.tolist() == new_r.tolist()
    _, slots_f2, new_f2 = keys.hash_upsert(idx_a, [words, nums])
    assert not new_f2.any() and (slots_f2 == slots_f).all()


def test_hash_upsert_unsupported_value_leaves_the_index_untouched():
    col = _obj([f"t{i}" for i in range(200)])
    col[150] = ("tuple", "cell")  # not serialised natively
    idx = index.KeyIndex()
    k, slots, is_new = keys.hash_upsert(idx, [col])
    assert k.tobytes() == ref_keys.keys_from_values([col]).tobytes()
    # one upsert of every row, none twice: the failed native pass inserted nothing
    assert len(idx) == 200 and is_new.all()
    assert sorted(slots.tolist()) == list(range(200))


def test_hash_upsert_on_a_python_index(no_native):
    col = _obj(["a", "b", "a"])
    idx = index.KeyIndex()
    assert isinstance(idx, index._PyKeyIndex)
    k, slots, is_new = keys.hash_upsert(idx, [col])
    assert k.tobytes() == ref_keys.keys_from_values([col]).tobytes()
    assert slots[0] == slots[2] != slots[1]
    assert is_new.tolist() == [True, True, False]


# -- DSV ---------------------------------------------------------------------------

DSV_TEXTS = [
    "a,b,c\n1,2,3\n4,5,6\n",
    'a,b\n"x,y",2\n"with ""quotes""",3\n',
    "a,b\r\n1,2\r\n",
    "a\nonly\n",
    "",
    "a,b\n1,\n,2\n",
    'a,b\n"multi\nline",5\n',
    "a,b\nlast,noeol",
    "a,b\n5'10\",x\n",  # a stray quote mid-field is literal
]


@pytest.mark.parametrize("text", DSV_TEXTS)
def test_split_dsv_matches_the_csv_module_and_the_reference(text):
    got = native.split_dsv(text.encode())
    assert got == [r for r in csv.reader(io.StringIO(text)) if r]
    assert got == ref_native.split_dsv(text.encode())


def test_split_dsv_cr_only_line_ends():
    text = "a,b\r1,2\r3,4\r"
    translated = text.replace("\r", "\n")
    got = native.split_dsv(text.encode())
    assert got == [r for r in csv.reader(io.StringIO(translated)) if r]
    assert got == ref_native.split_dsv(text.encode())


_FIELD = st.text(alphabet=st.sampled_from(list('ab ,"\né1;')), max_size=6)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.lists(_FIELD, min_size=1, max_size=4), min_size=1, max_size=6),
       st.sampled_from([",", ";", "\t"]))
def test_split_dsv_round_trips_csv_writer_output(rows, delimiter):
    buf = io.StringIO()
    csv.writer(buf, delimiter=delimiter, lineterminator="\n").writerows(rows)
    text = buf.getvalue()
    want = [r for r in csv.reader(io.StringIO(text), delimiter=delimiter) if r]
    got = native.split_dsv(text.encode(), delimiter)
    assert got == want
    assert got == ref_native.split_dsv(text.encode(), delimiter)


PARSE_CASES = [
    ('word,count,ok,score\n"a,b",notanint,true,1.5\nc,5,False,bad\n,,,\n',
     (("word", 0), ("count", 1), ("ok", 3), ("score", 2))),
    ("i,f\n99999999999999999999999999,1e-320\n1_000,0x1p3\n -7 ,inf\n",
     (("i", 1), ("f", 2))),
    ('"a\nb",c\n1,2\n', (("a\nb", 1), ("c", 1))),
    ('x\n""\nz\n', (("x", 0),)),
    ("x\n1\n", (("x", 1), ("missing", 0))),
    ("x,y\n1\n2,3,4\n", (("x", 1), ("y", 1))),
    ("b\ntrue\nTrue\n1\n0\nno\n", (("b", 3),)),
]


@pytest.mark.parametrize("data,selected", PARSE_CASES)
def test_parse_dsv_rows_equals_the_reference(data, selected):
    from pathway_tpu.engine.columnar import ERROR as REF_ERROR

    got = native.parse_dsv_rows(data.encode(), list(selected), ",", ERROR)
    want = ref_native.parse_dsv_rows(data.encode(), list(selected), ",", REF_ERROR)

    def norm(rows):
        return [{k: ("ERROR" if v is ERROR or v is REF_ERROR else v) for k, v in r.items()}
                for r in rows]

    assert norm(got) == norm(want)


def test_parse_dsv_rows_refuses_a_multibyte_delimiter():
    assert native.parse_dsv_rows("a¦b\n1¦2\n".encode(), [("a", 1)], "¦", ERROR) is None


def test_native_tables_refuse_what_the_c_side_cannot_take():
    with pytest.raises(TypeError, match="KEY_DTYPE"):
        index.KeyIndex().upsert(np.zeros(3, dtype=np.int64))
    mm = index.MultiMap()
    with pytest.raises(ValueError, match="non-negative"):
        mm.insert(_key_pool(2, 0), np.array([0, -1]))
    assert mm.total() == 0
