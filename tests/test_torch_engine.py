"""The port's dataflow engine against the reference engine.

Each program is built twice from the same definition, once with
``pathway_tpu`` and once with ``pathway_tpu_torch``, and both update streams
are captured: every (key, time, diff, values) must be equal. Rows within one
commit are compared as a multiset (the order of rows inside one delta is not
part of an update stream); keys, times, diffs and values are compared
exactly. The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G


def _norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (ref_pw.Json, pw.Json)):
        return ("json", v.dumps())
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    return v


def _stream(updates: list) -> dict:
    by_time: dict = {}
    for u in updates:
        row = tuple(sorted((k, _norm(v)) for k, v in u.items() if k not in ("__time__",)))
        by_time.setdefault(u["__time__"], []).append(row)
    return {t: sorted(rows, key=repr) for t, rows in by_time.items()}


def _both(program) -> tuple:
    REF_G.clear()
    want = _stream(ref_capture(program(ref_pw)))
    REF_G.clear()
    G.clear()
    got = _stream(capture(program(pw), device="cpu"))
    G.clear()
    return want, got


PEOPLE = """
    | name  | age | city   | score
  1 | alice | 30  | paris  | 1.5
  2 | bob   | 25  | berlin | 2.0
  3 | carol | 35  | paris  | 0.5
  4 | dave  | 41  | rome   | 3.25
  5 | erin  | 25  | berlin | 1.0
"""

PEOPLE_STREAM = """
    name  | age | city   | __time__ | __diff__
    alice | 30  | paris  | 2        | 1
    bob   | 25  | berlin | 2        | 1
    carol | 35  | paris  | 4        | 1
    alice | 30  | paris  | 6        | -1
    dave  | 41  | rome   | 6        | 1
    bob   | 25  | berlin | 8        | -1
    erin  | 25  | berlin | 8        | 1
"""

CITIES = """
    | city   | country
  1 | paris  | fr
  2 | berlin | de
  3 | oslo   | no
"""

CITIES_STREAM = """
    city   | country | __time__ | __diff__
    paris  | fr      | 2        | 1
    berlin | de      | 4        | 1
    paris  | fr      | 8        | -1
    rome   | it      | 8        | 1
"""


def _select(pw):
    t = pw.debug.table_from_markdown(PEOPLE)
    return t.select(
        pw.this.name,
        older=pw.this.age + 1,
        ratio=pw.this.score / 2,
        tag=pw.apply_with_type(lambda n, a: f"{n}:{a}", str, pw.this.name, pw.this.age),
        long=pw.this.name.str.len(),
    )


def _filter(pw):
    t = pw.debug.table_from_markdown(PEOPLE_STREAM)
    return t.filter((pw.this.age > 26) | (pw.this.city == "berlin")).with_columns(
        young=pw.this.age < 31
    )


def _flatten(pw):
    t = pw.debug.table_from_markdown(PEOPLE_STREAM)
    words = t.select(
        pw.this.age,
        parts=pw.apply_with_type(lambda n, c: [n, c, n + c], list, pw.this.name, pw.this.city),
    )
    return words.flatten(words.parts, origin_id="origin")


def _flatten_str(pw):
    t = pw.debug.table_from_markdown(PEOPLE)
    return t.select(pw.this.name).flatten(pw.this.name)


def _concat_reindex(pw):
    a = pw.debug.table_from_markdown(PEOPLE_STREAM).select(pw.this.name, pw.this.city)
    b = pw.debug.table_from_markdown(CITIES_STREAM).select(name=pw.this.country, city=pw.this.city)
    return a.concat_reindex(b)


def _groupby(pw):
    t = pw.debug.table_from_markdown(PEOPLE_STREAM)
    return t.groupby(pw.this.city).reduce(
        pw.this.city,
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.age),
        youngest=pw.reducers.min(pw.this.age),
        oldest=pw.reducers.max(pw.this.name),
        names=pw.reducers.tuple(pw.this.name),
        by_age=pw.reducers.tuple(pw.this.name, sort_by=pw.this.age),
    )


def _global_reduce(pw):
    t = pw.debug.table_from_markdown(PEOPLE_STREAM)
    return t.reduce(
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.age),
        last=pw.reducers.max(pw.this.age),
        names=pw.reducers.tuple(pw.this.name),
    )


def _float_sums(pw):
    t = pw.debug.table_from_markdown(PEOPLE)
    return t.groupby(pw.this.city).reduce(pw.this.city, s=pw.reducers.sum(pw.this.score))


def _join_left(pw):
    people = pw.debug.table_from_markdown(PEOPLE_STREAM)
    cities = pw.debug.table_from_markdown(CITIES_STREAM)
    return people.join_left(cities, people.city == cities.city, id=people.id).select(
        people.name, cities.country, both=pw.coalesce(cities.country, "?")
    )


def _join_left_no_id(pw):
    people = pw.debug.table_from_markdown(PEOPLE_STREAM)
    cities = pw.debug.table_from_markdown(CITIES_STREAM)
    return people.join_left(cities, pw.left.city == pw.right.city).select(
        pw.left.name, pw.right.country
    )


def _join_inner_static(pw):
    people = pw.debug.table_from_markdown(PEOPLE)
    cities = pw.debug.table_from_markdown(CITIES)
    return people.join(cities, people.city == cities.city).select(people.name, cities.country)


def _with_id_ix(pw):
    people = pw.debug.table_from_markdown(PEOPLE_STREAM)
    cities = pw.debug.table_from_markdown(CITIES_STREAM)
    pairs = people.join(cities, people.city == cities.city).select(people.name, at=cities.id)
    looked = cities.ix(pairs.at)
    return pairs.select(pairs.name, country=looked.country)


def _with_id(pw):
    people = pw.debug.table_from_markdown(PEOPLE_STREAM)
    counted = people.groupby(people.city).reduce(people.city, n=pw.reducers.count())
    return counted.with_id(pw.apply_with_type(lambda p: p, pw.Pointer, counted.id)).without("city")


def _knn(pw, as_of_now: bool):
    from importlib import import_module

    nn = import_module(pw.__name__ + ".stdlib.indexing.nearest_neighbors")
    device = {"device": "cpu"} if pw.__name__ == "pathway_tpu_torch" else {}
    rng = np.random.default_rng(5)
    vecs = [rng.integers(-9, 10, 4).astype(np.float32) for _ in range(6)]
    data = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, vec=np.ndarray),
        [(f"d{i}", vecs[i], t, d) for i, t, d in
         [(0, 2, 1), (1, 2, 1), (2, 4, 1), (3, 6, 1), (1, 8, -1), (4, 8, 1), (5, 12, 1)]],
        is_stream=True,
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(q=np.ndarray),
        [(vecs[0] + 1, 4, 1), (vecs[3] - 1, 6, 1), (vecs[0] + 1, 10, -1)],
        is_stream=True,
    )
    index = nn.BruteForceKnnFactory(
        dimensions=4, metric=nn.BruteForceKnnMetricKind.IP, **device
    ).build_index(data.vec, data)
    ask = index.query_as_of_now if as_of_now else index.query
    res = ask(queries.q, number_of_matches=2)
    return res.select(res._pw_index_reply_score, res.name)


PROGRAMS = {
    "select": _select,
    "filter_stream": _filter,
    "flatten_stream": _flatten,
    "flatten_str": _flatten_str,
    "concat_reindex_stream": _concat_reindex,
    "groupby_stream": _groupby,
    "global_reduce_stream": _global_reduce,
    "float_sums": _float_sums,
    "join_left_id_stream": _join_left,
    "join_left_stream": _join_left_no_id,
    "join_inner": _join_inner_static,
    "ix_stream": _with_id_ix,
    "with_id_stream": _with_id,
    "knn_as_of_now_stream": lambda pw: _knn(pw, True),
    "knn_reanswered_stream": lambda pw: _knn(pw, False),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_update_streams_equal_the_reference(name):
    want, got = _both(PROGRAMS[name])
    assert want, "the program emitted nothing"
    assert got == want


def test_segment_sum_on_the_device_path_matches_the_reference():
    """Above ``_DEVICE_THRESHOLD`` float32 sums take the port's sorted
    segmented reduction (here on the CPU) and the reference's XLA segment sum:
    rtol 1e-6 of the segment's sum of |values|. Integer sums stay exact."""
    from pathway_tpu.ops import segment as ref_segment
    from pathway_tpu_torch.ops import segment

    assert segment._DEVICE_THRESHOLD == ref_segment._DEVICE_THRESHOLD == 1 << 15
    rng = np.random.default_rng(0)
    n = (1 << 15) + 123
    ids = rng.integers(0, 700, n)
    vals = rng.normal(size=n).astype(np.float32)
    import torch

    got = segment.segment_sum_device(vals, ids, 700, torch.device("cpu"))
    want = ref_segment.segment_sum(vals, ids, 700)
    scale = np.zeros(700)
    np.add.at(scale, ids, np.abs(vals).astype(np.float64))
    assert got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-6 * scale)
    ints = rng.integers(-1000, 1000, n)
    assert np.array_equal(segment.segment_sum(ints, ids, 700), ref_segment.segment_sum(ints, ids, 700))


def test_groupby_large_float_sum_matches_the_reference():
    """2^15 + 7 float rows through ``groupby().reduce(sum)`` (float64 after the
    engine's column typing, so both engines sum on the host): rel 1e-6."""
    rng = np.random.default_rng(1)
    n = (1 << 15) + 7
    groups = rng.integers(0, 50, n).tolist()
    values = rng.normal(size=n).astype(np.float32)

    def program(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=int, v=float), list(zip(groups, values))
        )
        return t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v))

    REF_G.clear()
    want = {r["g"]: r["s"] for r in ref_capture(program(ref_pw))}
    REF_G.clear()
    G.clear()
    got = {r["g"]: r["s"] for r in capture(program(pw), device="cpu")}
    G.clear()
    assert got.keys() == want.keys()
    for g in want:
        assert got[g] == pytest.approx(want[g], rel=1e-6, abs=1e-6 * n)
