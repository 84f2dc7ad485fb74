"""``pw.temporal`` on the port against the reference.

Every program is built twice from one definition, once with ``pathway_tpu``
and once with ``pathway_tpu_torch``, and both update streams are captured:
each (key, time, diff, values) must be equal. Rows within one time are
compared as a multiset (the order of rows inside one delta is not part of an
update stream); keys, times, diffs and values are compared exactly. The
cases are those of the reference's temporal tests (behaviors, interval /
window / asof / asof-now joins, the typed window columns, inactivity
detection, the windows example), seeded random streams (numpy, fixed seeds)
for every window kind and join kind, and the commit profile's neu turns on
a forgetting pipeline. The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import datetime

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
    if isinstance(v, np.datetime64):
        return ("dt64", str(v.dtype), int(v.astype(np.int64)))
    if isinstance(v, np.timedelta64):
        return ("td64", str(v.dtype), int(v.astype(np.int64)))
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
        row = tuple(sorted((k, _norm(v)) for k, v in u.items() if k != "__time__"))
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


def _assert_same(program) -> dict:
    want, got = _both(program)
    assert got == want
    assert got, "the program emitted nothing: the case compares nothing"
    return got


def _JK(pw, name):
    return getattr(pw.JoinKind, name)


# -- the reference's behavior cases (tests/test_temporal_behavior.py) --------------


def _tumbling_delay(pw):
    t = pw.debug.table_from_markdown(
        """
        t | __time__
        1 | 0
        3 | 2
        9 | 4
        """
    )
    w = t.windowby(
        t.t,
        window=pw.temporal.tumbling(duration=2),
        behavior=pw.temporal.common_behavior(delay=2),
    )
    return w.reduce(pw.this._pw_window_start, cnt=pw.reducers.count())


def _exactly_once(pw):
    t = pw.debug.table_from_markdown(
        """
        t | __time__
        0 | 0
        1 | 2
        5 | 4
        """
    )
    w = t.windowby(
        t.t,
        window=pw.temporal.tumbling(duration=2),
        behavior=pw.temporal.exactly_once_behavior(),
    )
    return w.reduce(pw.this._pw_window_start, cnt=pw.reducers.count())


def _cutoff(keep_results):
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
            t | __time__
            1 | 0
            5 | 2
            1 | 4
            9 | 6
            """
        )
        w = t.windowby(
            t.t,
            window=pw.temporal.tumbling(duration=2),
            behavior=pw.temporal.common_behavior(cutoff=0, keep_results=keep_results),
        )
        return w.reduce(pw.this._pw_window_start, cnt=pw.reducers.count())

    return program


def _buffer_operator(pw):
    t = pw.debug.table_from_markdown(
        """
        v | __time__
        4 | 0
        1 | 2
        2 | 4
        """
    )
    return t._buffer(pw.this.v, pw.this.v)


def _intervals_over_outer(pw):
    data = pw.debug.table_from_markdown(
        """
        t  | v
        2  | 10
        3  | 20
        """
    )
    probes = pw.debug.table_from_markdown(
        """
        at
        2
        6
        """
    )
    w = data.windowby(
        data.t,
        window=pw.temporal.intervals_over(at=probes.at, lower_bound=-1, upper_bound=0, is_outer=True),
    )
    return w.reduce(pw.this._pw_window_start, cnt=pw.reducers.count())


BEHAVIOR_CASES = {
    "tumbling_delay": _tumbling_delay,
    "exactly_once": _exactly_once,
    "cutoff_keep_results": _cutoff(True),
    "cutoff_forget_results": _cutoff(False),
    "buffer_operator_order": _buffer_operator,
    "intervals_over_outer": _intervals_over_outer,
}


@pytest.mark.parametrize("case", sorted(BEHAVIOR_CASES))
def test_behavior_cases_equal_the_reference(case):
    _assert_same(BEHAVIOR_CASES[case])


def test_delay_holds_a_window_until_time_passes():
    stream = _assert_same(_tumbling_delay)
    # window [0, 2) (threshold 2) waits for the row t=3 (commit time 2)
    assert min(t for t, rows in stream.items() if any(("_pw_window_start", 0) in r for r in rows)) >= 2


def test_cutoff_forget_results_retracts_at_a_neu_time():
    stream = _assert_same(_cutoff(False))
    assert any(t % 2 == 1 for t in stream), stream  # forgetting retractions


# -- the reference's temporal-join cases (tests/test_temporal_joins.py) -------------


MODES = ["INNER", "LEFT", "RIGHT", "OUTER"]


def _interval_case(seed, mode, lo, hi, sharded, floats):
    def program(pw):
        rng = np.random.default_rng(seed)
        nl, nr = 17, 13
        if floats:
            lts = np.round(rng.uniform(0, 10, nl), 2).tolist()
            rts = np.round(rng.uniform(0, 10, nr), 2).tolist()
        else:
            lts = rng.integers(0, 12, nl).tolist()
            rts = rng.integers(0, 12, nr).tolist()
        lkeys = rng.integers(0, 3, nl).tolist()
        rkeys = rng.integers(0, 3, nr).tolist()
        ty = float if floats else int
        if sharded:
            left = pw.debug.table_from_rows(pw.schema_builder({"t": ty, "k": int}), list(zip(lts, lkeys)))
            right = pw.debug.table_from_rows(pw.schema_builder({"t2": ty, "k2": int}), list(zip(rts, rkeys)))
            return left.interval_join(
                right, left.t, right.t2, pw.temporal.interval(lo, hi), left.k == right.k2,
                how=_JK(pw, mode),
            ).select(lt=left.t, rt=right.t2)
        left = pw.debug.table_from_rows(pw.schema_builder({"t": ty}), [(t,) for t in lts])
        right = pw.debug.table_from_rows(pw.schema_builder({"t2": ty}), [(t,) for t in rts])
        return left.interval_join(
            right, left.t, right.t2, pw.temporal.interval(lo, hi), how=_JK(pw, mode)
        ).select(lt=left.t, rt=right.t2)

    return program


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bounds", [(-2, 2), (0, 3), (-3, -1), (1, 4), (0, 0)])
def test_interval_join_modes_bounds(mode, bounds):
    _assert_same(_interval_case(1, mode, bounds[0], bounds[1], sharded=False, floats=False))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode", MODES)
def test_interval_join_sharded(seed, mode):
    _assert_same(_interval_case(seed, mode, -2, 1, sharded=True, floats=False))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["INNER", "OUTER"])
def test_interval_join_float(seed, mode):
    _assert_same(_interval_case(seed, mode, -0.5, 0.75, sharded=False, floats=True))


def _interval_non_overlapping_outer(pw):
    left = pw.debug.table_from_rows(pw.schema_builder({"t": int}), [(0,), (1,)])
    right = pw.debug.table_from_rows(pw.schema_builder({"t2": int}), [(100,), (200,)])
    return left.interval_join_outer(right, left.t, right.t2, pw.temporal.interval(-1, 1)).select(
        lt=left.t, rt=right.t2
    )


def _interval_expressions(pw):
    left = pw.debug.table_from_rows(pw.schema_builder({"t": int, "a": int}), [(1, 10), (4, 40), (7, 70)])
    right = pw.debug.table_from_rows(pw.schema_builder({"t2": int, "b": int}), [(2, 1), (5, 2), (11, 3)])
    return left.interval_join_inner(right, left.t, right.t2, pw.temporal.interval(0, 2)).select(
        s=left.a + right.b, d=right.t2 - left.t
    )


def _window_join(mode, win):
    kind, duration, hop = win

    def program(pw):
        rng = np.random.default_rng(5)
        lts = rng.integers(0, 15, 14).tolist()
        rts = rng.integers(0, 15, 11).tolist()
        left = pw.debug.table_from_rows(pw.schema_builder({"t": int}), [(t,) for t in lts])
        right = pw.debug.table_from_rows(pw.schema_builder({"t2": int}), [(t,) for t in rts])
        w = (
            pw.temporal.tumbling(duration=duration)
            if kind == "tumbling"
            else pw.temporal.sliding(hop=hop, duration=duration)
        )
        return left.window_join(right, left.t, right.t2, w, how=_JK(pw, mode)).select(lt=left.t, rt=right.t2)

    return program


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("win", [("tumbling", 3, 3), ("sliding", 4, 2)])
def test_window_join(mode, win):
    _assert_same(_window_join(mode, win))


def _session_join(mode, use_predicate):
    def program(pw):
        left = pw.debug.table_from_rows(pw.schema_builder({"t": int}), [(1,), (2,), (10,)])
        right = pw.debug.table_from_rows(pw.schema_builder({"t2": int}), [(3,), (20,)])
        w = (
            pw.temporal.session(predicate=lambda a, b: abs(a - b) <= 2)
            if use_predicate
            else pw.temporal.session(max_gap=2)
        )
        return left.window_join(right, left.t, right.t2, w, how=_JK(pw, mode)).select(lt=left.t, rt=right.t2)

    return program


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_predicate", [False, True])
def test_session_window_join(mode, use_predicate):
    _assert_same(_session_join(mode, use_predicate))


def _session_join_sharded(pw):
    left = pw.debug.table_from_rows(pw.schema_builder({"t": int, "k": int}), [(1, 0), (2, 1), (3, 0)])
    right = pw.debug.table_from_rows(pw.schema_builder({"t2": int, "k2": int}), [(2, 0), (3, 1), (9, 0)])
    return left.window_join_inner(
        right, left.t, right.t2, pw.temporal.session(max_gap=1), left.k == right.k2
    ).select(lt=left.t, rt=right.t2, k=left.k)


def _window_join_columns(pw):
    left = pw.debug.table_from_rows(pw.schema_builder({"t": int}), [(1,), (5,)])
    right = pw.debug.table_from_rows(pw.schema_builder({"t2": int}), [(2,)])
    return left.window_join_left(right, left.t, right.t2, pw.temporal.tumbling(duration=4)).select(
        lt=left.t, ws=pw.this._pw_window_start
    )


ASOF_T1 = """
        | K | val |  t
    1   | 0 | 1   |  1
    2   | 0 | 2   |  4
    3   | 0 | 3   |  5
    4   | 0 | 4   |  6
    5   | 0 | 5   |  7
    6   | 0 | 6   |  11
    7   | 0 | 7   |  12
    8   | 1 | 8   |  5
    9   | 1 | 9   |  7
"""

ASOF_T2 = """
         | K | val | t
    21   | 1 | 7  | 2
    22   | 1 | 3  | 8
    23   | 0 | 0  | 2
    24   | 0 | 6  | 3
    25   | 0 | 2  | 7
    26   | 0 | 3  | 8
    27   | 0 | 9  | 9
    28   | 0 | 7  | 13
    29   | 0 | 4  | 14
"""


def _asof_full(pw):
    t1 = pw.debug.table_from_markdown(ASOF_T1)
    t2 = pw.debug.table_from_markdown(ASOF_T2)
    return t1.asof_join(
        t2, t1.t, t2.t, t1.K == t2.K, how=pw.JoinKind.OUTER, defaults={t1.val: 0, t2.val: 0}
    ).select(
        pw.this.instance, pw.this.side, pw.this.t,
        val_v1=t1.val, val_v2=t2.val, sum=t1.val + t2.val,
    )


LR_T1 = """
    | t | v
  1 | 1 | a
  2 | 5 | b
  3 | 9 | c
"""

LR_T2 = """
    | t | val
  1 | 3 | 30
  2 | 7 | 70
"""


def _asof_left_defaults(pw):
    t1 = pw.debug.table_from_markdown(LR_T1)
    t2 = pw.debug.table_from_markdown(LR_T2)
    return t1.asof_join_left(t2, t1.t, t2.t, defaults={t2.val: -1}).select(v=t1.v, rv=t2.val)


def _asof_right(pw):
    t1 = pw.debug.table_from_markdown(
        """
        | t | v
      1 | 2 | x
      2 | 6 | y
    """
    )
    t2 = pw.debug.table_from_markdown(
        """
        | t | w
      1 | 1 | p
      2 | 4 | q
      3 | 9 | r
    """
    )
    return t1.asof_join(t2, t1.t, t2.t, how=pw.JoinKind.RIGHT).select(w=t2.w, lv=t1.v, t=pw.this.t)


def _asof_direction(direction):
    def program(pw):
        t1 = pw.debug.table_from_markdown(LR_T1)
        t2 = pw.debug.table_from_markdown(LR_T2)
        kwargs = {}
        if direction is not None:
            kwargs["direction"] = getattr(pw.temporal.Direction, direction)
        return t1.asof_join_left(t2, t1.t, t2.t, **kwargs).select(v=t1.v, rv=t2.val)

    return program


def _asof_nearest_tie(pw):
    t1 = pw.debug.table_from_markdown(
        """
        | t
      1 | 5
    """
    )
    t2 = pw.debug.table_from_markdown(
        """
        | t | val
      1 | 3 | 1
      2 | 5 | 2
      3 | 8 | 3
    """
    )
    return t1.asof_join_left(t2, t1.t, t2.t, direction=pw.temporal.Direction.NEAREST).select(rv=t2.val)


def _asof_multiple_keys(pw):
    t1 = pw.debug.table_from_markdown(
        """
        | a | b | t | v
      1 | 0 | 0 | 5 | l1
      2 | 0 | 1 | 5 | l2
      3 | 1 | 0 | 5 | l3
    """
    )
    t2 = pw.debug.table_from_markdown(
        """
        | a | b | t | w
      1 | 0 | 0 | 3 | r1
      2 | 0 | 1 | 4 | r2
      3 | 1 | 1 | 2 | r3
    """
    )
    return t1.asof_join_left(t2, t1.t, t2.t, t1.a == t2.a, t1.b == t2.b).select(v=t1.v, w=t2.w)


def _interval_behavior_cutoff(pw):
    left = pw.debug.table_from_rows(
        pw.schema_builder({"t": int}), [(1, 0, 1), (2, 0, 1), (20, 2, 1), (3, 4, 1)], is_stream=True
    )
    right = pw.debug.table_from_rows(pw.schema_builder({"t2": int}), [(1,), (2,), (3,), (20,)])
    return left.interval_join_inner(
        right, left.t, right.t2, pw.temporal.interval(0, 0),
        behavior=pw.temporal.common_behavior(cutoff=2),
    ).select(lt=left.t, rt=right.t2)


def _interval_outer_null_flip(pw):
    left = pw.debug.table_from_rows(pw.schema_builder({"t": int}), [(10, 0, 1)], is_stream=True)
    right = pw.debug.table_from_rows(
        pw.schema_builder({"t2": int, "v": int}), [(100, 0, 0, 1), (11, 7, 2, 1)], is_stream=True
    )
    return left.interval_join_outer(right, left.t, right.t2, pw.temporal.interval(-2, 2)).select(
        lt=left.t, rv=right.v
    )


def _asof_now_first_answers(pw):
    queries = pw.debug.table_from_rows(pw.schema_builder({"q": int}), [(1, 2, 1), (2, 6, 1)], is_stream=True)
    state = pw.debug.table_from_rows(
        pw.schema_builder({"k": int, "ver": str}),
        [(0, "v1", 0, 1), (0, "v1", 4, -1), (0, "v2", 4, 1)],
        is_stream=True,
    )
    return queries.asof_now_join(state).select(q=queries.q, ver=state.ver)


JOIN_CASES = {
    "interval_non_overlapping_outer": _interval_non_overlapping_outer,
    "interval_expressions": _interval_expressions,
    "session_join_sharded": _session_join_sharded,
    "window_join_columns": _window_join_columns,
    "asof_full_two_sided_defaults": _asof_full,
    "asof_left_defaults": _asof_left_defaults,
    "asof_right": _asof_right,
    "asof_backward": _asof_direction(None),
    "asof_forward": _asof_direction("FORWARD"),
    "asof_nearest": _asof_direction("NEAREST"),
    "asof_nearest_tie": _asof_nearest_tie,
    "asof_multiple_keys": _asof_multiple_keys,
    "interval_behavior_cutoff": _interval_behavior_cutoff,
    "interval_outer_null_flip": _interval_outer_null_flip,
    "asof_now_first_answers": _asof_now_first_answers,
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_cases_equal_the_reference(case):
    _assert_same(JOIN_CASES[case])


def test_asof_now_join_never_retracts_an_answer():
    stream = _assert_same(_asof_now_first_answers)
    rows = [dict(r) for rows in stream.values() for r in rows]
    assert all(r["__diff__"] > 0 for r in rows)
    assert {r["q"]: r["ver"] for r in rows} == {1: "v1", 2: "v2"}


# -- typed window columns (tests/test_type_inference.py) and stdlib cases -----------


def _typed_tumbling(pw):
    t = pw.debug.table_from_markdown(
        """
        t  | v
        1  | 10
        12 | 30
        """
    )
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, s=pw.reducers.sum(pw.this.v)
    )


def _typed_sliding(pw):
    t = pw.debug.table_from_markdown(
        """
        t  | v
        4  | 10
        """
    )
    return t.windowby(t.t, window=pw.temporal.sliding(hop=2, duration=6)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, c=pw.reducers.count()
    )


def _typed_session(pw):
    t = pw.debug.table_from_markdown(
        """
        t   | v
        1   | 1
        2   | 1
        30  | 1
        """
    )
    return t.windowby(t.t, window=pw.temporal.session(max_gap=5)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, c=pw.reducers.count()
    )


def _typed_datetime(pw):
    base = datetime.datetime(2025, 1, 1)
    t = pw.debug.table_from_rows(
        pw.schema_builder({"ts": pw.DateTimeNaive, "v": int}),
        [(base + datetime.timedelta(minutes=m), m) for m in (0, 5, 25)],
    )
    return t.windowby(t.ts, window=pw.temporal.tumbling(duration=datetime.timedelta(minutes=10))).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v)
    )


TYPED_CASES = {
    "tumbling": _typed_tumbling,
    "sliding": _typed_sliding,
    "session": _typed_session,
    "datetime": _typed_datetime,
}


@pytest.mark.parametrize("case", sorted(TYPED_CASES))
def test_typed_window_columns_equal_the_reference(case):
    _assert_same(TYPED_CASES[case])
    REF_G.clear()
    want = {n: repr(c.dtype) for n, c in TYPED_CASES[case](ref_pw)._schema.columns().items()}
    REF_G.clear()
    G.clear()
    got = {n: repr(c.dtype) for n, c in TYPED_CASES[case](pw)._schema.columns().items()}
    G.clear()
    assert got == want
    assert "ANY" not in got.get("start", "")


def _inactivity(pw):
    DT = datetime.datetime

    def ts(s):
        return DT(2026, 1, 1, 0, 0, s)

    events = pw.debug.table_from_rows(
        pw.schema_from_types(t=DT),
        [(ts(0), 1, 1), (ts(1), 2, 1), (ts(2), 3, 1), (ts(20), 40, 1), (ts(21), 41, 1)],
        is_stream=True,
    )
    now = pw.debug.table_from_rows(
        pw.schema_from_types(timestamp_utc=DT),
        [(ts(3), 4, 1), (ts(8), 10, 1), (ts(13), 20, 1), (ts(22), 45, 1)],
        is_stream=True,
    )
    inact, resumed = pw.temporal.inactivity_detection(events.t, datetime.timedelta(seconds=5), now_table=now)
    # one table out: the two results side by side, keyed apart
    return inact.select(kind="inactive", t=inact.inactive_t).concat_reindex(
        resumed.select(kind="resumed", t=resumed.resumed_t)
    )


def _timed_sources_clock(pw):
    t1 = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1, 2, 1), (2, 6, 1)], is_stream=True)
    t2 = pw.debug.table_from_rows(pw.schema_from_types(b=int), [(10, 4, 1)], is_stream=True)
    latest = t1.groupby().reduce(m=pw.reducers.max(t1.a))
    return t2.asof_now_join(latest).select(b=t2.b, m=latest.m)


def _example_windows(pw):
    readings = pw.debug.table_from_markdown(
        """
        sensor | t  | value | __time__ | __diff__
        1      | 2  | 10    | 0        | 1
        1      | 7  | 20    | 0        | 1
        2      | 3  | 5     | 0        | 1
        1      | 13 | 40    | 2        | 1
        1      | 4  | 30    | 2        | 1
        2      | 25 | 9     | 4        | 1
        1      | 38 | 1     | 6        | 1
        """
    )
    return readings.windowby(
        readings.t,
        window=pw.temporal.tumbling(duration=10),
        instance=readings.sensor,
        behavior=pw.temporal.common_behavior(delay=2, cutoff=30, keep_results=True),
    ).reduce(
        sensor=pw.this._pw_instance,
        start=pw.this._pw_window_start,
        total=pw.reducers.sum(pw.this.value),
        n=pw.reducers.count(),
    )


STDLIB_CASES = {
    "inactivity_detection": _inactivity,
    "timed_sources_share_global_clock": _timed_sources_clock,
    "example_windows_and_behaviors": _example_windows,
}


@pytest.mark.parametrize("case", sorted(STDLIB_CASES))
def test_stdlib_cases_equal_the_reference(case):
    _assert_same(STDLIB_CASES[case])


def test_example_windows_final_values():
    stream = _assert_same(_example_windows)
    state: dict = {}
    for t in sorted(stream):
        for r in stream[t]:
            r = dict(r)
            key = (r["sensor"], r["start"])
            if r["__diff__"] > 0:
                state[key] = (r["total"], r["n"])
            elif state.get(key) == (r["total"], r["n"]):
                del state[key]
    assert state[(1, 0)] == (60, 3)
    assert state[(1, 10)] == (40, 1)


# -- seeded random streams -----------------------------------------------------------


def _random_stream(seed, n=60, n_times=8, span=40, retract_share=0.15):
    """Rows (t, k, v, __time__, __diff__): inserts over ``n_times`` commits,
    some retracted in a later commit."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, span, n)
    ks = rng.integers(0, 3, n)
    vs = rng.integers(0, 100, n)
    commits = np.sort(rng.integers(0, n_times, n)) * 2
    rows = [(int(t), int(k), int(v), int(c), 1) for t, k, v, c in zip(ts, ks, vs, commits)]
    out = list(rows)
    for i in np.nonzero(rng.random(n) < retract_share)[0]:
        t, k, v, c, _ = rows[i]
        later = int(c) + 2 * int(rng.integers(1, 3))
        out.append((t, k, v, later, -1))
    return sorted(out, key=lambda r: r[3])


def _random_window(seed, window, behavior):
    def program(pw):
        t = pw.debug.table_from_rows(
            pw.schema_builder({"t": int, "k": int, "v": int}), _random_stream(seed), is_stream=True
        )
        w = {
            "tumbling": pw.temporal.tumbling(duration=7),
            "sliding": pw.temporal.sliding(hop=3, duration=9),
            "session": pw.temporal.session(max_gap=2),
        }[window]
        b = {
            None: None,
            "keep": pw.temporal.common_behavior(delay=3, cutoff=4, keep_results=True),
            "forget": pw.temporal.common_behavior(delay=3, cutoff=4, keep_results=False),
            "exactly_once": pw.temporal.exactly_once_behavior(),
        }[behavior]
        if window == "session" and behavior == "exactly_once":
            b = None  # exactly-once needs a window duration
        return t.windowby(t.t, window=w, instance=t.k, behavior=b).reduce(
            k=pw.this._pw_instance,
            start=pw.this._pw_window_start,
            end=pw.this._pw_window_end,
            n=pw.reducers.count(),
            s=pw.reducers.sum(pw.this.v),
            vs=pw.reducers.sorted_tuple(pw.this.v),
        )

    return program


def _datetime_window_behavior(pw):
    rng = np.random.default_rng(13)
    base = datetime.datetime(2026, 3, 1)
    rows = [
        (base + datetime.timedelta(seconds=int(s)), int(k), int(c) * 2, 1)
        for s, k, c in zip(rng.integers(0, 120, 40), rng.integers(0, 2, 40), np.sort(rng.integers(0, 6, 40)))
    ]
    t = pw.debug.table_from_rows(pw.schema_builder({"ts": pw.DateTimeNaive, "k": int}), rows, is_stream=True)
    return t.windowby(
        t.ts,
        window=pw.temporal.tumbling(duration=datetime.timedelta(seconds=20)),
        instance=t.k,
        behavior=pw.temporal.common_behavior(
            delay=datetime.timedelta(seconds=5), cutoff=datetime.timedelta(seconds=10)
        ),
    ).reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start, n=pw.reducers.count())


def test_datetime_windows_with_behavior_equal_the_reference():
    _assert_same(_datetime_window_behavior)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("behavior", [None, "keep", "forget", "exactly_once"])
@pytest.mark.parametrize("window", ["tumbling", "sliding", "session"])
def test_random_windows_equal_the_reference(window, behavior, seed):
    _assert_same(_random_window(seed, window, behavior))


def _random_join(seed, family, mode):
    def program(pw):
        schema_l = pw.schema_builder({"t": int, "k": int, "v": int})
        schema_r = pw.schema_builder({"t": int, "k": int, "v": int})
        left = pw.debug.table_from_rows(schema_l, _random_stream(seed, n=25), is_stream=True)
        right = pw.debug.table_from_rows(schema_r, _random_stream(seed + 100, n=20), is_stream=True)
        how = _JK(pw, mode)
        if family == "interval":
            jr = left.interval_join(
                right, left.t, right.t, pw.temporal.interval(-3, 2), left.k == right.k, how=how
            )
        elif family == "asof":
            jr = left.asof_join(right, left.t, right.t, left.k == right.k, how=how)
        else:
            jr = left.window_join(right, left.t, right.t, pw.temporal.tumbling(duration=6), left.k == right.k, how=how)
        return jr.select(lt=left.t, lv=left.v, rt=right.t, rv=right.v)

    return program


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["interval", "asof", "window"])
def test_random_joins_equal_the_reference(family, mode):
    _assert_same(_random_join(21, family, mode))


def _random_asof_now(pw):
    rng = np.random.default_rng(31)
    state = pw.debug.table_from_rows(
        pw.schema_builder({"k": int, "v": int}),
        sorted(
            [(int(k), int(v), int(c) * 2, 1) for k, v, c in zip(
                rng.integers(0, 4, 20), rng.integers(0, 50, 20), rng.integers(0, 6, 20))],
            key=lambda r: r[2],
        ),
        is_stream=True,
    )
    latest = state.groupby(state.k).reduce(state.k, m=pw.reducers.max(state.v))
    queries = pw.debug.table_from_rows(
        pw.schema_builder({"q": int, "k": int}),
        [(i, int(k), 2 * i + 1, 1) for i, k in enumerate(rng.integers(0, 4, 8))],
        is_stream=True,
    )
    return queries.asof_now_join_left(latest, queries.k == latest.k).select(q=queries.q, m=latest.m)


def test_random_asof_now_join_equals_the_reference():
    _assert_same(_random_asof_now)


# -- the commit profile's neu turns --------------------------------------------------


def _neu_turns(mod_pw, G_, profile, capture_fn, **kw):
    G_.clear()
    profile.reset_profile()
    capture_fn(_cutoff(False)(mod_pw), **kw)
    ring = profile.get_flight_recorder().payload("end")["profiles"]
    out = []
    for p in ring:
        neu_ops = sorted(
            [o["name"], o["kind"], o["rows"], o["retractions"]] for o in p["ops"] if o["neu"]
        )
        out.append((p["commit"], p["neu"], neu_ops))
    G_.clear()
    return out


def test_commit_profile_neu_turns_equal_the_reference(monkeypatch):
    # the reference's fused chains would merge operator rows: compare its
    # stock per-operator dispatch, as the port runs
    monkeypatch.setenv("PATHWAY_FUSION", "off")
    from pathway_tpu.engine import profile as ref_profile
    from pathway_tpu_torch.engine import profile as port_profile

    want = _neu_turns(ref_pw, REF_G, ref_profile, ref_capture)
    got = _neu_turns(pw, G, port_profile, capture, device="cpu")
    assert got == want
    assert any(neu for _c, neu, _ops in got)
    assert any(ops and any(o[3] for o in ops) for _c, _neu, ops in got)


# -- the .dt and .num namespaces -----------------------------------------------------


def _dt_fields(pw):
    base = datetime.datetime(2024, 2, 28, 22, 59, 58, 123456)
    rows = [
        (base + datetime.timedelta(hours=h, seconds=7 * h, microseconds=311 * h),
         datetime.timedelta(days=h % 3, hours=h, seconds=h * 13, microseconds=5 * h))
        for h in range(0, 60, 7)
    ]
    t = pw.debug.table_from_rows(pw.schema_builder({"ts": pw.DateTimeNaive, "d": pw.Duration}), rows)
    return t.select(
        y=t.ts.dt.year(), mo=t.ts.dt.month(), day=t.ts.dt.day(), h=t.ts.dt.hour(),
        mi=t.ts.dt.minute(), s=t.ts.dt.second(), ms=t.ts.dt.millisecond(),
        us=t.ts.dt.microsecond(), ns=t.ts.dt.nanosecond(), stamp=t.ts.dt.timestamp(),
        stamp_s=t.ts.dt.timestamp(unit="s"), text=t.ts.dt.strftime("%Y-%m-%d %H:%M:%S"),
        floor=t.ts.dt.floor(datetime.timedelta(minutes=15)),
        rounded=t.ts.dt.round(datetime.timedelta(hours=1)),
        local=t.ts.dt.to_naive_in_timezone("Europe/Warsaw"),
        utc=t.ts.dt.to_utc("America/New_York"),
        d_s=t.d.dt.seconds(), d_ms=t.d.dt.milliseconds(), d_h=t.d.dt.hours(),
        d_days=t.d.dt.days(), d_w=t.d.dt.weeks(),
    )


def _num_namespace(pw):
    t = pw.debug.table_from_rows(
        pw.schema_builder({"i": int, "f": float, "o": float | None}),
        [(-3, -2.345, None), (4, 1.005, 2.5), (0, -0.5, None)],
    )
    return t.select(
        ai=t.i.num.abs(), af=t.f.num.abs(), r=t.f.num.round(2), r0=t.f.num.round(),
        filled=t.o.num.fill_na(0.0),
    )


@pytest.mark.parametrize("case", ["dt", "num"])
def test_namespaces_equal_the_reference(case):
    _assert_same({"dt": _dt_fields, "num": _num_namespace}[case])


def test_dt_round_ties_to_even_as_the_reference():
    # 00:30 and 01:30 round to the even hour, as pandas rounds
    def program(pw):
        t = pw.debug.table_from_rows(
            pw.schema_builder({"ts": pw.DateTimeNaive}),
            [(datetime.datetime(2025, 5, 5, h, 30),) for h in range(4)],
        )
        return t.select(r=t.ts.dt.round(datetime.timedelta(hours=1)))

    stream = _assert_same(program)
    hours = sorted(dict(r)["r"][2] // 3_600_000_000_000 % 24 for rows in stream.values() for r in rows)
    assert hours == [0, 2, 2, 4]
