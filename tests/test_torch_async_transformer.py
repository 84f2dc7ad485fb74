"""``pw.AsyncTransformer`` and the loop-back source on the port against the
reference.

Each program is built with both packages from the same seeded inputs and
run to its end. An async transformer's results come back through a
loop-back source whose commits follow the invocations' timing, so its
update streams differ run to run in their commit boundaries: they are
compared as final states (key and row), never time by time. The cases are
the reference's own (``tests/test_transformers.py``: the failed table,
instance poisoning, ``with_options`` retries), a seeded stream of commits
with removals and updates held against a replay, capacity, the order of a
downstream ``on_end``, and two transformers chained. The python and fs
connectors' update streams through ``pw.run`` keep their parity with the
reference under the run loop's split end of input.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from tests.torch_parity import bounded, clear_graphs, final_rows

def _both_final(program, which: str) -> tuple:
    """(reference, port) final states of ``getattr(program(pkg), which)``."""
    clear_graphs()
    want = final_rows(ref_pw, getattr(program(ref_pw), which))
    clear_graphs()
    got = final_rows(pw, getattr(program(pw), which))
    clear_graphs()
    return want, got


# -- the reference's own cases ---------------------------------------------------


def _flaky(pkg):
    class OutSchema(pkg.Schema):
        ret: int

    class Flaky(pkg.AsyncTransformer, output_schema=OutSchema):
        async def invoke(self, value) -> dict:
            if value == 13:
                raise RuntimeError("boom")
            return {"ret": value + 1}

    t = pkg.debug.table_from_rows(pkg.schema_builder({"value": int}), [(1,), (13,), (3,)])
    return Flaky(input_table=t)


def _poisoned(pkg, **options):
    class OutSchema(pkg.Schema):
        ret: int

    class Flaky(pkg.AsyncTransformer, output_schema=OutSchema):
        async def invoke(self, value, grp) -> dict:
            if value == 2:
                raise RuntimeError("boom")
            return {"ret": value * 10}

    t = pkg.debug.table_from_rows(
        pkg.schema_builder({"value": int, "grp": int}), [(1, 0), (2, 0), (3, 1)]
    )
    return Flaky(input_table=t, instance=t.grp, **options)


CASES = {"failed_table": _flaky, "instance_poisoning": _poisoned}


@pytest.mark.parametrize("which", ["successful", "failed", "finished", "result"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases_equal_the_reference(case, which):
    want, got = _both_final(CASES[case], which)
    assert got == want
    assert got or which == "failed", "the case compares nothing"


def test_instance_poisoning_fails_the_whole_group():
    clear_graphs()
    rows = final_rows(pw, _poisoned(pw).finished)
    clear_graphs()
    statuses = sorted((dict(row)["_async_status"], dict(row)["ret"]) for _key, row in rows)
    assert statuses == [("-FAILURE-", None), ("-FAILURE-", None), ("-SUCCESS-", 30)]


def _retrying(pkg, attempts: dict):
    class OutSchema(pkg.Schema):
        ret: int

    class Retrying(pkg.AsyncTransformer, output_schema=OutSchema):
        async def invoke(self, value) -> dict:
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("transient")
            return {"ret": value}

    t = pkg.debug.table_from_rows(pkg.schema_builder({"value": int}), [(7,)])
    return Retrying(input_table=t).with_options(
        retry_strategy=pkg.udfs.FixedDelayRetryStrategy(max_retries=5, delay_ms=1)
    )


def test_with_options_retries_equal_the_reference():
    counts = {}
    finals = {}
    for name, pkg in (("ref", ref_pw), ("port", pw)):
        clear_graphs()
        counts[name] = {"n": 0}
        finals[name] = final_rows(pkg, _retrying(pkg, counts[name]).successful)
    clear_graphs()
    assert finals["port"] == finals["ref"]
    assert [dict(row) for _k, row in finals["port"]] == [{"ret": 7}]
    assert counts["port"]["n"] == counts["ref"]["n"] == 3


def test_explicit_commits_release_each_group_as_one_commit():
    """``autocommit_duration_ms=None``: the loop-back source commits once per
    released (instance, time) group, so a group's rows share one time."""
    clear_graphs()
    tr = _poisoned(pw, autocommit_duration_ms=None)
    updates = bounded(lambda: pw.debug._capture_update_stream(tr.finished, device="cpu"))
    clear_graphs()
    times = {}
    for u in updates:
        times.setdefault((u["_async_status"], u["ret"]), set()).add(u["__time__"])
    assert sorted(times) == [("-FAILURE-", None), ("-SUCCESS-", 30)]
    assert len(times[("-FAILURE-", None)]) == 1  # both rows of group 0 in one commit
    assert sum(1 for u in updates if u["__diff__"] > 0) == 3


# -- a seeded stream: commits, removals, updates ---------------------------------


def _seeded_events(seed: int, n: int = 60, groups: int = 7, times: int = 4):
    """Markdown rows (id, value, grp, time, diff): every row added at one
    of the first ``times`` commits, then a quarter removed and a quarter
    updated (a new value under the same id) at the last commit."""
    rng = np.random.default_rng(seed)
    rows = []
    live = {}
    for i in range(n):
        t = 2 * int(rng.integers(1, times + 1))
        live[i] = (int(rng.integers(0, 1000)), int(rng.integers(0, groups)))
        rows.append((i, *live[i], t, 1))
    last = 2 * (times + 1)
    for i in rng.choice(n, n // 2, replace=False).tolist():
        value, grp = live.pop(i)
        rows.append((i, value, grp, last, -1))
        if i % 2:
            live[i] = (int(rng.integers(0, 1000)), grp)
            rows.append((i, *live[i], last, 1))
    return rows


def _markdown(rows) -> str:
    lines = ["   | value | grp | __time__ | __diff__"]
    lines += [f"{i} | {v} | {g} | {t} | {d}" for i, v, g, t, d in rows]
    return "\n".join(lines)


def _failing(value: int) -> bool:
    return value % 11 == 3


def _seeded(seed: int):
    rows = _seeded_events(seed)

    def program(pkg):
        class OutSchema(pkg.Schema):
            ret: int
            grp: int

        class Doubler(pkg.AsyncTransformer, output_schema=OutSchema):
            async def invoke(self, value, grp) -> dict:
                await asyncio.sleep(0.001 * (value % 3))
                if _failing(value):
                    raise ValueError(value)
                return {"ret": 2 * value, "grp": grp}

        t = pkg.debug.table_from_markdown(_markdown(rows))
        return Doubler(input_table=t, instance=t.grp)

    return rows, program


def _replay(rows) -> dict:
    """Final (status, ret) by id: an (instance, time) group with a failing
    addition fails as a whole; a removal retracts; the last group wins."""
    poisoned = {(g, t) for _i, v, g, t, d in rows if d > 0 and _failing(v)}
    out: dict = {}
    for i, v, g, t, d in sorted(rows, key=lambda r: (r[3], r[4])):  # removals first
        if d < 0:
            out.pop(i, None)
        elif (g, t) in poisoned:
            out[i] = ("-FAILURE-", None)
        else:
            out[i] = ("-SUCCESS-", 2 * v)
    return out


@pytest.mark.parametrize("which", ["successful", "failed", "finished"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_stream_with_removals_and_updates_equals_the_reference(seed, which):
    rows, program = _seeded(seed)
    want, got = _both_final(program, which)
    assert got == want
    expected = _replay(rows)
    statuses = {"successful": {"-SUCCESS-"}, "failed": {"-FAILURE-"},
                "finished": {"-SUCCESS-", "-FAILURE-"}}[which]
    assert len(got) == sum(1 for s, _r in expected.values() if s in statuses)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_stream_equals_its_replay(seed):
    rows, program = _seeded(seed)
    clear_graphs()
    final = final_rows(pw, program(pw).finished)
    clear_graphs()
    ids = sorted({r[0] for r in rows})  # a row's key is its id's, in every table
    id_table = pw.debug.table_from_markdown("   | rid\n" + "\n".join(f"{i} | {i}" for i in ids))
    id_of = {key: dict(row)["rid"] for key, row in final_rows(pw, id_table)}
    clear_graphs()
    got = {id_of[key]: (dict(row)["_async_status"], dict(row)["ret"]) for key, row in final}
    assert got == _replay(rows)


def test_a_removed_row_retracts_and_an_updated_row_upserts():
    md = """
       | value | __time__ | __diff__
    1  | 1     | 2        | 1
    2  | 2     | 2        | 1
    3  | 3     | 2        | 1
    2  | 2     | 4        | -1
    3  | 3     | 4        | -1
    3  | 30    | 4        | 1
    """

    def program(pkg):
        class OutSchema(pkg.Schema):
            ret: int

        class Plus(pkg.AsyncTransformer, output_schema=OutSchema):
            async def invoke(self, value) -> dict:
                return {"ret": value + 1}

        return Plus(input_table=pkg.debug.table_from_markdown(md))

    want, got = _both_final(program, "successful")
    assert got == want
    assert sorted(dict(row)["ret"] for _k, row in got) == [2, 31]


# -- capacity, the end of the stream, chaining ------------------------------------


class _InFlight:
    def __init__(self):
        self.now = 0
        self.peak = 0
        self.done: list = []

    async def around(self, coro_fn):
        self.now += 1
        self.peak = max(self.peak, self.now)
        try:
            return await coro_fn()
        finally:
            self.now -= 1
            self.done.append(time.monotonic())


def _counted(pkg, meter: _InFlight, capacity: int | None, n: int = 64):
    class OutSchema(pkg.Schema):
        ret: int

    class Slow(pkg.AsyncTransformer, output_schema=OutSchema):
        async def invoke(self, value) -> dict:
            async def body():
                await asyncio.sleep(0.005)
                return {"ret": value}

            return await meter.around(body)

    t = pkg.debug.table_from_rows(pkg.schema_builder({"value": int}), [(i,) for i in range(n)])
    tr = Slow(input_table=t)
    return tr.with_options(capacity=capacity) if capacity else tr


@pytest.mark.parametrize("capacity", [1, 4, 16])
def test_capacity_bounds_the_invocations_in_flight(capacity):
    peaks = {}
    for name, pkg in (("ref", ref_pw), ("port", pw)):
        clear_graphs()
        meter = _InFlight()
        rows = final_rows(pkg, _counted(pkg, meter, capacity).successful)
        assert len(rows) == 64 and len(meter.done) == 64
        peaks[name] = meter.peak
    clear_graphs()
    assert peaks["port"] <= capacity and peaks["ref"] <= capacity
    clear_graphs()
    meter = _InFlight()
    final_rows(pw, _counted(pw, meter, None).successful)
    clear_graphs()
    assert meter.peak > 16  # without a capacity, the rows of a commit run at once


def test_a_downstream_subscriber_hears_the_end_after_the_last_invocation():
    clear_graphs()
    meter = _InFlight()
    tr = _counted(pw, meter, 8)
    seen: list = []
    ended: list = []

    def on_change(key, row, time, is_addition):
        seen.append(row["ret"])

    def on_end():
        ended.append((time.monotonic(), len(seen)))

    pw.io.subscribe(tr.successful.select(ret=pw.this.ret * 2), on_change=on_change, on_end=on_end)
    bounded(lambda: pw.run(device="cpu"))
    clear_graphs()
    assert len(ended) == 1
    end_at, rows_before = ended[0]
    assert rows_before == 64 and sorted(seen) == [2 * i for i in range(64)]
    assert end_at >= max(meter.done)


def _chained(pkg, closes: list):
    class Mid(pkg.Schema):
        mid: int

    class Out(pkg.Schema):
        out: int

    class First(pkg.AsyncTransformer, output_schema=Mid):
        async def invoke(self, value) -> dict:
            await asyncio.sleep(0.002)
            if value % 5 == 4:
                raise RuntimeError("first")
            return {"mid": value * 3}

        def close(self):
            closes.append("first")

    class Second(pkg.AsyncTransformer, output_schema=Out):
        async def invoke(self, mid) -> dict:
            await asyncio.sleep(0.002)
            return {"out": mid + 1}

        def close(self):
            closes.append("second")

    t = pkg.debug.table_from_rows(pkg.schema_builder({"value": int}), [(i,) for i in range(20)])
    return Second(input_table=First(input_table=t).successful)


@pytest.mark.parametrize("which", ["successful", "finished"])
def test_two_chained_transformers_close_in_cascade(which):
    closes: dict = {"ref": [], "port": []}
    clear_graphs()
    want = final_rows(ref_pw, getattr(_chained(ref_pw, closes["ref"]), which))
    clear_graphs()
    got = final_rows(pw, getattr(_chained(pw, closes["port"]), which))
    clear_graphs()
    assert got == want
    assert sorted(dict(row)["out"] for _k, row in got) == [3 * v + 1 for v in range(20) if v % 5 != 4]
    assert closes["port"] == ["first", "second"]


def test_the_loop_back_source_is_finished_only_once_closed():
    from pathway_tpu_torch.engine.datasource import StreamingDataSource

    source = StreamingDataSource(autocommit_ms=None, loopback=True)
    assert source.loopback and not source.is_finished()
    source.push({"a": 1})
    source.commit()
    assert len(source.next_batch(["a"])) == 1 and not source.is_finished()
    source.close()
    assert len(source.next_batch(["a"])) == 0 and source.is_finished()
    assert not StreamingDataSource().loopback


# -- connectors through pw.run under the split end of input ------------------------


def _python_feed(pkg, seed: int):
    rng = np.random.default_rng(seed)
    batches = [[(f"k{int(k)}", int(v)) for k, v in rng.integers(0, 40, size=(25, 2))]
               for _ in range(4)]

    class Feed(pkg.io.python.ConnectorSubject):
        def run(self):
            for batch in batches:
                for key, value in batch:
                    self.next(key=key, value=value)
                self.commit()

    schema = pkg.schema_builder({
        "key": pkg.column_definition(dtype=str, primary_key=True),
        "value": pkg.column_definition(dtype=int),
    })
    t = pkg.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)
    t = t.select(t.value, bucket=t.value % 4)
    return t.groupby(t.bucket).reduce(t.bucket, n=pkg.reducers.count(),
                                      total=pkg.reducers.sum(t.value))


@pytest.mark.parametrize("seed", [0, 1])
def test_python_connector_through_pw_run_equals_the_reference(seed):
    """Commit boundaries of a connector thread depend on timing: final states."""
    results = {}
    for name, pkg in (("ref", ref_pw), ("port", pw)):
        clear_graphs()
        table = _python_feed(pkg, seed)
        final: dict = {}
        ended: list = []

        def on_change(key, row, time, is_addition, final=final):
            if is_addition:
                final[row["bucket"]] = (row["n"], row["total"])
            elif final.get(row["bucket"]) == (row["n"], row["total"]):
                del final[row["bucket"]]

        pkg.io.subscribe(table, on_change=on_change, on_end=lambda ended=ended: ended.append(1))
        if pkg is pw:
            bounded(lambda: pw.run(device="cpu"))
        else:
            bounded(ref_pw.run)
        results[name] = (final, ended)
    clear_graphs()
    assert results["port"][0] == results["ref"][0] and results["port"][0]
    assert results["port"][1] == results["ref"][1] == [1]


def test_fs_static_read_through_pw_run_equals_the_reference(tmp_path):
    """The reference's static read may split its files over commits of its
    autocommit tick: final states."""
    (tmp_path / "a.csv").write_text("word,n\nx,1\ny,2\nx,5\n")
    (tmp_path / "b.csv").write_text("word,n\nz,7\ny,1\n")

    def program(pkg):
        t = pkg.io.csv.read(str(tmp_path), schema=pkg.schema_from_types(word=str, n=int),
                            mode="static")
        return t.groupby(t.word).reduce(t.word, total=pkg.reducers.sum(t.n))

    clear_graphs()
    want = final_rows(ref_pw, program(ref_pw))
    clear_graphs()
    got = final_rows(pw, program(pw))
    clear_graphs()
    assert got == want
    assert sorted(dict(row)["total"] for _k, row in got) == [3, 6, 7]
