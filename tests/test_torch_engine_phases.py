"""The port's commit loop: the alt / neu phases and operators that hold rows.

A buffer's rows flush at stream close, in the commit after the sources
finished, at the reference's time; a commit in which no source released
rows runs no operator while none holds rows (the idle skip the served
phases rely on), and runs the holding operators when one does; and the
key-presence operators (update_rows, difference, having, intersect,
restrict) give the reference's update streams under retractions.
"""

from __future__ import annotations

import threading
import time

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals.parse_graph import G

from .test_torch_temporal import _assert_same

# -- buffers flush at stream close -----------------------------------------------


def _buffer_never_ripe(pw):
    t = pw.debug.table_from_markdown(
        """
        v | __time__
        4 | 0
        1 | 2
        2 | 4
        """
    )
    # thresholds far past any time the stream reaches: only the drain emits
    return t._buffer(pw.this.v + 100, pw.this.v)


def test_buffer_rows_flush_at_stream_close():
    stream = _assert_same(_buffer_never_ripe)
    assert len(stream) == 1, stream  # one commit: the drain
    (flush_time,) = stream
    # three data commits (times 0, 2, 4), then the drain commit
    assert flush_time == 6
    assert sorted(dict(r)["v"] for r in stream[flush_time]) == [1, 2, 4]


def _buffer_then_forget(pw):
    t = pw.debug.table_from_markdown(
        """
        v  | __time__
        1  | 0
        5  | 2
        12 | 4
        """
    )
    buffered = t._buffer(pw.this.v + 3, pw.this.v)
    return buffered._forget(pw.this.v + 4, pw.this.v, True)


def test_buffer_then_forget_equals_the_reference():
    stream = _assert_same(_buffer_then_forget)
    assert any(t % 2 == 1 for t in stream)  # the forgetting ran in a neu phase


# -- the idle skip ------------------------------------------------------------------


class _Held(pw.io.python.ConnectorSubject):
    """Pushes one committed row, then holds the stream open until released."""

    def __init__(self) -> None:
        self.release = threading.Event()

    def run(self) -> None:
        self.next(v=1)
        self.commit()
        self.release.wait(30)


def _counting(runner: GraphRunner, node) -> list:
    calls = []
    evaluator = runner.evaluators[node.id]
    inner = evaluator.process
    evaluator.process = lambda deltas: (calls.append(1), inner(deltas))[1]
    return calls


def _stepped(program):
    G.clear()
    subject = _Held()
    src = pw.io.python.read(subject, schema=pw.schema_from_types(v=int), autocommit_duration_ms=None)
    out = program(src)
    rows = []
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: rows.append((row["v"], time, is_addition)))
    runner = GraphRunner(G)
    runner.setup()
    return subject, runner, out, rows


def _step_until_rows(runner: GraphRunner) -> None:
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        runner.step()
        if runner._input_rows:
            return
        time.sleep(0.01)
    raise AssertionError("the subject's row never arrived")


def test_idle_tick_with_no_pending_operator_runs_no_operator():
    subject, runner, out, rows = _stepped(lambda t: t.select(v=t.v + 1))
    try:
        calls = _counting(runner, out._node)
        _step_until_rows(runner)
        assert len(calls) == 1 and [r[0] for r in rows] == [2]
        before = len(calls)
        for _ in range(3):
            assert runner.step() is False
        assert len(calls) == before  # skipped: nothing released, nothing held
        assert not runner.has_pending()
    finally:
        subject.release.set()
        runner.finish()
        G.clear()


def test_idle_tick_runs_an_operator_that_holds_rows_and_the_drain_flushes_it():
    subject, runner, out, rows = _stepped(lambda t: t._buffer(t.v + 100, t.v))
    try:
        calls = _counting(runner, out._node)
        _step_until_rows(runner)
        assert rows == [] and runner.has_pending()
        before = len(calls)
        assert runner.step() is False  # idle, but the buffer gets its turn
        assert len(calls) == before + 1
        subject.release.set()
        deadline = time.monotonic() + 30
        while not runner.sources_finished() and time.monotonic() < deadline:
            runner.step()
            time.sleep(0.01)
        assert runner.sources_finished()
        assert runner.step() is True  # draining: the buffered row flushes
        assert [(v, add) for v, _t, add in rows] == [(1, True)]
        assert not runner.has_pending()
    finally:
        subject.release.set()
        runner.finish()
        G.clear()


def test_run_returns_after_the_drain_commit():
    G.clear()
    t = pw.debug.table_from_markdown(
        """
        v | __time__
        4 | 0
        """
    )
    got = []
    pw.io.subscribe(
        t._buffer(t.v + 100, t.v),
        on_change=lambda key, row, time, is_addition: got.append((row["v"], time)),
        on_end=lambda: got.append("end"),
    )
    pw.run(device="cpu")
    G.clear()
    assert got == [(4, 2), "end"]


# -- key-presence operators under retractions -----------------------------------------

BASE = """
       | k | a  | __time__ | __diff__
    1  | 1 | 10 | 0        | 1
    2  | 2 | 20 | 0        | 1
    3  | 3 | 30 | 2        | 1
    1  | 1 | 10 | 4        | -1
    1  | 1 | 11 | 4        | 1
    4  | 4 | 40 | 6        | 1
    2  | 2 | 20 | 8        | -1
"""

PATCH = """
       | k | a   | __time__ | __diff__
    2  | 2 | 200 | 2        | 1
    5  | 5 | 500 | 2        | 1
    1  | 1 | 100 | 4        | 1
    2  | 2 | 200 | 6        | -1
    3  | 3 | 300 | 8        | 1
    1  | 1 | 100 | 10       | -1
"""


def _update_rows(pw):
    return pw.debug.table_from_markdown(BASE).update_rows(pw.debug.table_from_markdown(PATCH))


def _difference(pw):
    return pw.debug.table_from_markdown(BASE).difference(pw.debug.table_from_markdown(PATCH))


def _intersect(pw):
    return pw.debug.table_from_markdown(BASE).intersect(pw.debug.table_from_markdown(PATCH))


def _restrict(pw):
    base = pw.debug.table_from_markdown(BASE)
    return base.restrict(base.filter(base.a > 15))


def _having(pw):
    base = pw.debug.table_from_markdown(BASE)
    patch = pw.debug.table_from_markdown(PATCH)
    refs = patch.select(p=base.pointer_from(patch.k))
    keyed = base.with_id(base.pointer_from(base.k))
    return keyed.having(refs.p)


PRESENCE_CASES = {
    "update_rows": _update_rows,
    "difference": _difference,
    "intersect": _intersect,
    "restrict": _restrict,
    "having": _having,
}


@pytest.mark.parametrize("case", sorted(PRESENCE_CASES))
def test_key_presence_operators_equal_the_reference(case):
    stream = _assert_same(PRESENCE_CASES[case])
    if case in ("update_rows", "difference", "having"):
        assert any(dict(r)["__diff__"] < 0 for rows in stream.values() for r in rows)
