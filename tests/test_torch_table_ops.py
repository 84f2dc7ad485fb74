"""The engine's remaining operators on the port against the reference.

Every program is built twice from one definition, once with ``pathway_tpu``
and once with ``pathway_tpu_torch``, and both update streams are captured:
each (key, time, diff, values) must be equal, rows within one time compared
as a multiset. The cases are those of the reference's tests
(``tests/test_common.py``, ``test_common_corners.py``,
``test_sorting_index.py``, ``test_transformers.py``'s gradual broadcast) and
seeded random streams with retractions and late rows: deduplicate,
update_cells, concat / split / slice / rename and the typing helpers,
with_universe_of and the universe promises, sort and the sorted index,
remove_errors with the global and local error logs, the gradual broadcast.
The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.engine.columnar import Error as RefError
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.engine.columnar import Error
from pathway_tpu_torch.internals.parse_graph import G


def _norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (Error, RefError)):
        return ("error",)
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, float) and v != v:
        return ("nan",)
    return v


def _stream(updates: list) -> dict:
    by_time: dict = {}
    for u in updates:
        row = tuple(sorted((k, _norm(v)) for k, v in u.items() if k != "__time__"))
        by_time.setdefault(u["__time__"], []).append(row)
    return {t: sorted(rows, key=repr) for t, rows in by_time.items()}


def _clear_ref() -> None:
    """A fresh reference graph: its ``clear`` keeps the cached global error
    log table, whose node the cleared graph no longer holds."""
    REF_G.clear()
    for attr in ("_global_error_log", "_error_log_source", "_error_log_stack"):
        REF_G._current.__dict__.pop(attr, None)


@pytest.fixture(autouse=True)
def _no_fusion(monkeypatch):
    # the port has no operator fusion: the reference runs its per-node dispatch
    monkeypatch.setenv("PATHWAY_FUSION", "off")


def _both(program, **kwargs) -> tuple:
    _clear_ref()
    want = _stream(ref_capture(program(ref_pw), **kwargs))
    REF_G.clear()
    G.clear()
    got = _stream(capture(program(pw), device="cpu", **kwargs))
    G.clear()
    return want, got


def _assert_same(program, **kwargs) -> dict:
    want, got = _both(program, **kwargs)
    assert got == want
    assert got, "the program emitted nothing: the case compares nothing"
    return got


def _raises_in_both(program, exc, **kwargs) -> None:
    """Both runs fail with ``exc`` (the reference wraps an operator's error
    in ``EngineErrorWithTrace``, whose ``cause`` it is)."""
    for pkg, cap, graph, extra in (
        (ref_pw, ref_capture, REF_G, {}),
        (pw, capture, G, {"device": "cpu"}),
    ):
        _clear_ref()
        graph.clear()
        try:
            with pytest.raises(Exception) as info:
                cap(program(pkg), **kwargs, **extra)
            err = info.value
            assert isinstance(err, exc) or isinstance(getattr(err, "cause", None), exc), err
        finally:
            graph.clear()


# -- deduplicate -------------------------------------------------------------------


def _dedup_increasing(pw):
    t = pw.debug.table_from_markdown(
        """
        a | __time__
        1 | 0
        5 | 2
        3 | 4
        """
    )
    return t.deduplicate(value=pw.this.a, acceptor=lambda new, old: new > old)


def _dedup_instances(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b | __time__
        1 | x | 0
        3 | x | 2
        2 | y | 2
        5 | y | 4
        4 | x | 4
        9 | x | 4
        """
    )
    return t.deduplicate(value=pw.this.a, instance=pw.this.b, acceptor=lambda new, old: new > old)


def _dedup_retractions_ignored(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | g | __time__ | __diff__
        1 | 4 | 0 | 0        | 1
        2 | 7 | 0 | 2        | 1
        2 | 7 | 0 | 4        | -1
        3 | 2 | 1 | 4        | 1
        """
    )
    return pw.stateful.deduplicate(
        t, value=t.a, instance=t.g, acceptor=lambda new, old: abs(new - old) > 1
    )


def _dedup_no_acceptor(pw):
    t = pw.debug.table_from_markdown(
        """
        a | __time__
        1 | 0
        2 | 2
        """
    )
    return t.deduplicate(value=pw.this.a)


def _dedup_random(seed):
    def program(pw):
        rng = np.random.default_rng(seed)
        rows = [(int(rng.integers(0, 5)), float(rng.normal()), 2 * int(i // 7)) for i in range(60)]
        t = pw.debug.table_from_markdown(
            "g | v | __time__\n" + "\n".join(f"{g} | {v!r} | {t}" for g, v, t in rows)
        )
        return t.deduplicate(
            value=t.v, instance=t.g, acceptor=lambda new, old: abs(new - old) > 0.5
        )

    return program


DEDUP = {
    "increasing": _dedup_increasing,
    "instances": _dedup_instances,
    "retractions_ignored": _dedup_retractions_ignored,
    "no_acceptor": _dedup_no_acceptor,
    **{f"random_{s}": _dedup_random(s) for s in (0, 1, 2)},
}


@pytest.mark.parametrize("name", sorted(DEDUP))
def test_deduplicate_streams_equal_the_reference(name):
    _assert_same(DEDUP[name])


# -- update_cells ------------------------------------------------------------------


def _update_cells_basic(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | b
        1 | 1 | x
        2 | 2 | y
        """
    )
    p = pw.debug.table_from_markdown(
        """
          | b
        2 | z
        """
    )
    return t.update_cells(p)


def _update_cells_stream(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | b | __time__ | __diff__
        1 | 1 | x | 0        | 1
        2 | 2 | y | 0        | 1
        3 | 3 | z | 4        | 1
        1 | 1 | x | 6        | -1
        """
    )
    p = pw.debug.table_from_markdown(
        """
          | b | __time__ | __diff__
        1 | q | 2        | 1
        1 | q | 4        | -1
        2 | r | 4        | 1
        3 | s | 2        | 1
        """
    )
    return t << p


def _update_cells_same_commit(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | b | __time__
        1 | 1 | x | 0
        2 | 2 | y | 2
        """
    )
    p = pw.debug.table_from_markdown(
        """
          | a | __time__
        2 | 20 | 2
        """
    )
    return t.update_cells(p)


def _update_cells_empty_patch(pw):
    t = pw.debug.table_from_markdown(
        """
          | a
        1 | 1
        """
    )
    p = t.filter(t.a > 5).select(t.a)
    return t.update_cells(p)


UPDATE_CELLS = {
    "basic": _update_cells_basic,
    "stream": _update_cells_stream,
    "same_commit": _update_cells_same_commit,
    "empty_patch": _update_cells_empty_patch,
}


@pytest.mark.parametrize("name", sorted(UPDATE_CELLS))
def test_update_cells_streams_equal_the_reference(name):
    _assert_same(UPDATE_CELLS[name])


def test_update_cells_unknown_column_raises_in_both():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | a
            1 | 1
            """
        )
        p = pw.debug.table_from_markdown(
            """
              | c
            1 | 2
            """
        )
        return t.update_cells(p)

    for pkg, graph in ((ref_pw, REF_G), (pw, G)):
        graph.clear()
        with pytest.raises(ValueError):
            program(pkg)
        graph.clear()


# -- concat, split, slice, rename, typing -----------------------------------------------


def _concat(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | __time__ | __diff__
        1 | 1 | 0        | 1
        2 | 2 | 0        | 1
        2 | 2 | 2        | -1
        """
    )
    u = pw.debug.table_from_markdown(
        """
          | a | __time__
        3 | 3 | 0
        2 | 9 | 2
        """
    )
    return t.concat(u)


def _split(pw):
    t = pw.debug.table_from_markdown(
        """
        a | __time__
        1 | 0
        6 | 0
        8 | 2
        """
    )
    pos, neg = t.split(t.a > 5)
    return pos.select(a=pos.a, side=1).concat_reindex(neg.select(a=neg.a, side=0))


def _slice_rename(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b | c
        1 | x | 2.5
        2 | y | 3.5
        """
    )
    r = t.rename_columns(aa=pw.this.a).rename({"b": "bb"}).rename_by_dict({"c": "cc"})
    s = r.select(*r.slice.without("cc").with_prefix("p_"), **r.slice.rename({"cc": "z"}))
    return s.copy()


def _typing(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 2
        3 | 4
        """
    )
    return t.cast_to_types(a=float).update_types(b=int).with_id_from(pw.this.b)


def _ix_ref(pw):
    t = pw.debug.table_from_markdown(
        """
        name | v
        x    | 1
        y    | 2
        """
    ).with_id_from(pw.this.name)
    q = pw.debug.table_from_markdown(
        """
        who
        y
        x
        y
        """
    )
    return q.select(q.who, v=t.ix_ref(q.who).v)


RELATIONAL = {
    "concat": _concat,
    "split": _split,
    "slice_rename": _slice_rename,
    "typing": _typing,
    "ix_ref": _ix_ref,
}


@pytest.mark.parametrize("name", sorted(RELATIONAL))
def test_relational_helpers_stream_equal_the_reference(name):
    _assert_same(RELATIONAL[name])


def test_concat_of_overlapping_universes_raises_in_both():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | a
            1 | 1
            """
        )
        u = pw.debug.table_from_markdown(
            """
              | a
            1 | 2
            """
        )
        return t.concat(u)

    _raises_in_both(program, ValueError)


def test_concat_reindex_keys_are_the_references():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | a
            1 | 1
            2 | 2
            """
        )
        return t.concat_reindex(t, t.select(a=t.a * 10))

    _assert_same(program)


# -- with_universe_of and the universe promises ---------------------------------------


def _with_universe_of(pw):
    t = pw.debug.table_from_markdown(
        """
          | a | __time__ | __diff__
        1 | 1 | 0        | 1
        2 | 2 | 0        | 1
        2 | 2 | 2        | -1
        """
    )
    s = t.select(b=t.a * 10)
    s.promise_universe_is_equal_to(t)
    return s.with_universe_of(t)


def _promised_subset(pw):
    t = pw.debug.table_from_markdown(
        """
          | a
        1 | 1
        2 | 2
        3 | 3
        """
    )
    sub = pw.debug.table_from_markdown(
        """
          | b
        2 | 20
        """
    )
    sub.promise_universe_is_subset_of(t)
    both = t.intersect(sub)
    return t.restrict(both)


PROMISES = {"with_universe_of": _with_universe_of, "promised_subset": _promised_subset}


@pytest.mark.parametrize("name", sorted(PROMISES))
def test_universe_operators_stream_equal_the_reference(name):
    _assert_same(PROMISES[name])


def test_with_universe_of_without_a_known_equality_raises_in_both():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | a
            1 | 1
            """
        )
        u = pw.debug.table_from_markdown(
            """
              | b
            1 | 2
            """
        )
        return t.with_universe_of(u)

    for pkg, graph in ((ref_pw, REF_G), (pw, G)):
        graph.clear()
        with pytest.raises(ValueError):
            program(pkg)
        graph.clear()


def test_with_universe_of_violated_at_runtime_raises_in_both():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | a
            1 | 1
            2 | 2
            """
        )
        u = pw.debug.table_from_markdown(
            """
              | b
            1 | 2
            """
        )
        t.promise_universe_is_equal_to(u)
        return t.with_universe_of(u)

    _raises_in_both(program, RuntimeError)


# -- sort and the sorted index ---------------------------------------------------------


def _sort_instances(pw):
    t = pw.debug.table_from_markdown(
        """
          | k | g | __time__ | __diff__
        1 | 5 | a | 0        | 1
        2 | 3 | a | 0        | 1
        3 | 4 | b | 2        | 1
        4 | 1 | a | 2        | 1
        2 | 3 | a | 4        | -1
        5 | 9 | b | 4        | 1
        6 | 4 | a | 6        | 1
        """
    )
    return t.sort(t.k, instance=t.g)


def _sort_ties_and_moves(pw):
    t = pw.debug.table_from_markdown(
        """
          | k | __time__ | __diff__
        1 | 2 | 0        | 1
        2 | 2 | 0        | 1
        3 | 2 | 0        | 1
        2 | 2 | 2        | -1
        2 | 7 | 2        | 1
        4 | 0 | 4        | 1
        """
    )
    return t.sort(t.k)


def _sort_random(seed):
    def program(pw):
        rng = np.random.default_rng(seed)
        lines = ["  | k | g | __time__ | __diff__"]
        live: dict = {}
        for step in range(40):
            t = 2 * (step // 5)
            rid = int(rng.integers(1, 20))
            if rid in live and rng.random() < 0.4:
                k, g = live.pop(rid)
                lines.append(f"{rid} | {k} | {g} | {t} | -1")
            elif rid not in live:
                k, g = int(rng.integers(0, 10)), int(rng.integers(0, 3))
                live[rid] = (k, g)
                lines.append(f"{rid} | {k} | {g} | {t} | 1")
        tab = pw.debug.table_from_markdown("\n".join(lines))
        return tab.sort(tab.k, instance=tab.g)

    return program


def _sorted_index(pw):
    t = pw.debug.table_from_markdown(
        """
          | key | instance | __time__ | __diff__
        1 | 5   | 0        | 0        | 1
        2 | 3   | 0        | 0        | 1
        3 | 8   | 0        | 2        | 1
        4 | 1   | 1        | 2        | 1
        5 | 6   | 0        | 4        | 1
        2 | 3   | 0        | 6        | -1
        """
    )
    return pw.indexing.build_sorted_index(t)["index"]


def _sorted_index_oracle(pw):
    t = pw.debug.table_from_markdown(
        """
          | key | instance
        1 |  4  | 0
        2 |  1  | 0
        3 |  9  | 0
        4 |  6  | 0
        5 |  2  | 1
        6 |  8  | 1
        """
    )
    return pw.indexing.build_sorted_index(t)["oracle"]


def _sort_from_index(pw):
    t = pw.debug.table_from_markdown(
        """
          | key | instance
        1 |  10 | 7
        2 |  3  | 7
        3 |  7  | 7
        4 |  1  | 7
        5 |  5  | 7
        6 |  12 | 7
        """
    )
    return pw.indexing.sort_from_index(pw.indexing.build_sorted_index(t)["index"])


def _retrieve_prev_next(pw):
    ordered = pw.debug.table_from_markdown(
        """
          | t | value
        1 | 1 |
        2 | 2 | 20.0
        3 | 3 |
        4 | 4 |
        5 | 5 | 50.0
        6 | 6 |
        """
    )
    s = ordered.sort(ordered.t)
    chained = ordered.select(prev=s.prev, next=s.next, value=ordered.value)
    return pw.indexing.retrieve_prev_next_values(chained)


SORTS = {
    "instances": _sort_instances,
    "ties_and_moves": _sort_ties_and_moves,
    **{f"random_{s}": _sort_random(s) for s in (0, 1, 2, 3)},
    "sorted_index": _sorted_index,
    "sorted_index_oracle": _sorted_index_oracle,
    "sort_from_index": _sort_from_index,
    "retrieve_prev_next_values": _retrieve_prev_next,
}


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_and_sorted_index_streams_equal_the_reference(name):
    _assert_same(SORTS[name])


# -- remove_errors and the error logs -------------------------------------------------------


def _divide(a, b):
    return 10 // int(b)


def _global_log(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b | __time__
        1 | 0 | 0
        2 | 1 | 0
        3 | 0 | 2
        4 | 2 | 2
        """
    )
    r = t.select(t.a, q=pw.apply(_divide, t.a, t.b))
    kept = r.remove_errors()
    return kept.select(kept.a, kept.q).concat_reindex(
        pw.global_error_log().select(a=pw.this.operator_id, q=pw.this.message)
    )


def _error_log_rows(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 0
        2 | 1
        """
    )
    t.select(q=pw.apply(_divide, t.a, t.b))
    return pw.global_error_log()


def _local_log(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b | __time__
        1 | 0 | 0
        2 | 1 | 0
        3 | 0 | 2
        """
    )
    with pw.local_error_log() as log:
        inner = t.select(q=pw.apply(_divide, t.a, t.b))
    outer = t.select(q=pw.apply(_divide, t.b, t.a))
    inner.filter(inner.q > 1).remove_errors()
    outer.remove_errors()
    return log.select(log.operator_id, log.message).concat_reindex(
        pw.global_error_log().select(pw.this.operator_id, pw.this.message)
    )


def _failing_filter(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 0
        2 | 1
        3 | 2
        """
    )
    kept = t.filter(pw.apply_with_type(lambda a, b: 10 // int(b) > 4, bool, t.a, t.b))
    return kept.concat_reindex(
        pw.global_error_log().select(a=pw.this.operator_id, b=pw.this.operator_id)
    )


ERRORS = {
    "global_log": _global_log,
    "error_log_rows": _error_log_rows,
    "local_log": _local_log,
    "failing_filter": _failing_filter,
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_remove_errors_and_error_logs_equal_the_reference(name):
    _assert_same(ERRORS[name], terminate_on_error=False)


def test_failing_udf_still_raises_when_terminating():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
            a | b
            1 | 0
            """
        )
        return t.select(q=pw.apply(_divide, t.a, t.b))

    _raises_in_both(program, ZeroDivisionError)


# -- the gradual broadcast -------------------------------------------------------------------


def _gradual_hysteresis(pw):
    t = pw.debug.table_from_markdown(
        """
        name
        a
        b
        c
        d
        e
        f
        """
    )
    thr = pw.debug.table_from_markdown(
        """
        lower | value | upper | __time__
        0.0   | 0.5   | 1.0   | 0
        0.4   | 0.6   | 1.0   | 4
        """
    )
    return t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper)


def _gradual_stream(pw):
    t = pw.debug.table_from_markdown(
        """
          | name | __time__ | __diff__
        1 | a    | 0        | 1
        2 | b    | 0        | 1
        3 | c    | 4        | 1
        2 | b    | 6        | -1
        """
    )
    thr = pw.debug.table_from_markdown(
        """
        lower | value | upper | __time__
        0.0   | 1.0   | 2.0   | 2
        1.5   | 1.7   | 2.0   | 6
        0.0   | 0.1   | 0.2   | 8
        """
    )
    return t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper)


GRADUAL = {"hysteresis": _gradual_hysteresis, "stream": _gradual_stream}


@pytest.mark.parametrize("name", sorted(GRADUAL))
def test_gradual_broadcast_streams_equal_the_reference(name):
    _assert_same(GRADUAL[name])


def test_new_node_kinds_are_the_references():
    """Every node kind of the reference's parse graph, but the one it builds
    nowhere and runs nowhere (``stateful_reduce``), has its counterpart and
    evaluator in the port."""
    from pathway_tpu.internals import parse_graph as ref_pg
    from pathway_tpu_torch.engine.evaluators import EVALUATORS
    from pathway_tpu_torch.internals import parse_graph as pg

    def kinds(mod):
        return {
            c.kind for c in vars(mod).values()
            if isinstance(c, type) and issubclass(c, mod.Node) and c is not mod.Node
        }

    left_out = {"stateful_reduce"}
    assert kinds(pg) == kinds(ref_pg) - left_out
    assert {cls.kind for cls in EVALUATORS} == kinds(pg)


# -- pw.load_yaml ------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "template",
    [
        "a: 1\nb: [x, 2.5]\n",
        "$k: 7\nlimit: $k\nnested: {v: $k, w: [$k, 3]}\n",
        "$w: !pw.temporal.tumbling\n  duration: 5\nwindow: $w\n",
    ],
    ids=["plain", "variables", "pw_tag"],
)
def test_load_yaml_templates_equal_the_reference(template):
    pytest.importorskip("yaml")

    def shape(v):
        if isinstance(v, dict):
            return {k: shape(x) for k, x in v.items()}
        if isinstance(v, list):
            return [shape(x) for x in v]
        if isinstance(v, (int, float, str, bool)) or v is None:
            return v
        return (type(v).__name__, sorted((k, repr(x)) for k, x in vars(v).items()))

    assert shape(pw.load_yaml(template)) == shape(ref_pw.load_yaml(template))
