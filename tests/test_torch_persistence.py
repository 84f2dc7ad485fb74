"""The port's persistence against the reference's: the journal, replay on
resume, the segment markers, the fs scanner's state and checkpoints.

Each of ``tests/test_persistence.py``'s cases is one program run under both
packages over a store of its own: the final outputs, the sink deliveries of
each run (where the commit structure is deterministic), the journal's row
counts and the refusals' error types must be equal, and the reference test's
own expectations must hold for the port. The kill-and-restart cases run each
package's program in a child process, killed with SIGKILL and restarted on
the same store.

Beside them: ``pw.run(persistence_config=...)`` and ``PATHWAY_REPLAY_STORAGE``
resume a program from its journal (the port ignored both before
persistence was ported), and a rehearsal on the CPU of ``chip_smoke.py``'s
``persist`` phase against the reference's same program.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import pytest

from .torch_parity import clear_graphs, norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120  # a child that has not ended by then is killed
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


class Pkg:
    """One package's persistence surface, by name."""

    def __init__(self, name: str):
        self.name = name
        self.pw = importlib.import_module(name)
        mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
        self.GraphRunner = mod("engine.runner").GraphRunner
        self.pg = mod("internals.parse_graph")
        self.G = self.pg.G
        self.StreamingDataSource = mod("engine.datasource").StreamingDataSource
        self.Table = mod("internals.table").Table
        self.pointer_from = mod("internals.keys").pointer_from
        self.PersistenceManager = mod("persistence.engine").PersistenceManager
        self.config = mod("internals.config")
        self.run_kw = {"device": "cpu"} if name == "pathway_tpu_torch" else {}

    def run(self, **kwargs) -> None:
        self.GraphRunner(self.G._current).run(**kwargs, **self.run_kw)

    def fs_config(self, store, **kwargs):
        return self.pw.persistence.Config(self.pw.persistence.Backend.filesystem(store), **kwargs)

    def journal_rows(self, cfg) -> int:
        frames = self.PersistenceManager(cfg).load_journal(self.G._current.sig())
        return sum(len(d) for _cid, deltas, _offs in frames for d in deltas.values())


def _row(row: dict) -> tuple:
    return tuple(sorted((k, norm(v)) for k, v in row.items()))


def _collect(P: Pkg, table, log: "list | None" = None) -> dict:
    """The table's live rows (row key -> row), and every delivery in ``log``."""
    rows: dict = {}

    def on_change(key, row, time, is_addition):
        if log is not None:
            log.append((_row(row), is_addition))
        if is_addition:
            rows[key.as_int()] = row
        else:
            rows.pop(key.as_int(), None)

    P.pw.io.subscribe(table, on_change)
    return rows


def _final(rows: dict) -> list:
    return sorted(_row(r) for r in rows.values())


def _static_pipeline(P: Pkg, log: "list | None" = None) -> dict:
    t = P.pw.debug.table_from_markdown(
        """
        word  | n
        cat   | 1
        dog   | 2
        cat   | 3
        """
    )
    counts = t.groupby(t.word).reduce(t.word, total=P.pw.reducers.sum(t.n))
    return _collect(P, counts, log)


def _numbers_pipeline(P: Pkg, n: int) -> dict:
    class NumbersSubject:
        """Pushes 0..n-1 in order; a re-push is skipped by the consumed count."""

        def run(self, source):
            for i in range(n):
                source.push({"v": i})

    source = P.StreamingDataSource(subject=NumbersSubject(), autocommit_ms=5)
    node = P.G.add_node(P.pg.InputNode(source=source, streaming=True, name="numbers"))
    t = P.Table(node, P.pw.schema_builder({"v": int}), name="numbers")
    return _collect(P, t.reduce(total=P.pw.reducers.sum(t.v)))


def _run_segmented(P: Pkg, store, script, max_commits=None) -> dict:
    """A scripted subject pushing segments (begin, rows, state markers,
    barriers); returns the captured rows."""

    class ScriptedSubject:
        def __init__(self):
            self.folded: list = []

        def restore(self, state_deltas):
            self.folded = list(state_deltas)

        def run(self, source):
            for step in script(self.folded):
                kind = step[0]
                if kind == "begin":
                    source.push_begin(step[1], step[2])
                elif kind == "row":
                    source.push(step[1], diff=step[2] if len(step) > 2 else 1)
                elif kind == "state":
                    source.push_state(step[1])
                elif kind == "barrier":
                    source.push_barrier()

    source = P.StreamingDataSource(subject=ScriptedSubject(), autocommit_ms=5)
    node = P.G.add_node(P.pg.InputNode(source=source, streaming=True, name="seg"))
    t = P.Table(node, P.pw.schema_builder({"v": int}), name="seg")
    rows = _collect(P, t)
    P.run(persistence_config=P.fs_config(store), max_commits=max_commits)
    return rows


def _csv_counts(P: Pkg, input_dir, log: "list | None" = None) -> dict:
    t = P.pw.io.csv.read(
        str(input_dir), schema=P.pw.schema_builder({"word": str}), mode="static"
    )
    counts = t.groupby(t.word).reduce(t.word, total=P.pw.reducers.count())
    return _collect(P, counts, log)


def _totals(rows: dict) -> dict:
    return {r["word"]: int(r["total"]) for r in rows.values()}


# -- the cases of tests/test_persistence.py ---------------------------------------


def case_journal_replay_reproduces_state(P: Pkg, tmp) -> dict:
    cfg = P.fs_config(tmp / "pstore")
    out: dict = {}
    for run in (1, 2):
        clear_graphs()
        log: list = []
        rows = _static_pipeline(P, log)
        P.run(persistence_config=cfg)
        out[f"run{run}"] = {"final": _final(rows), "deliveries": sorted(log)}
    out["journal_rows"] = P.journal_rows(cfg)
    assert {dict(r)["word"] for r in out["run1"]["final"]} == {"cat", "dog"}
    assert out["run2"]["final"] == out["run1"]["final"]
    assert out["journal_rows"] == 3  # one copy of the input, not two
    return out


def case_streaming_resume_after_partial_run(P: Pkg, tmp) -> dict:
    cfg = P.fs_config(tmp / "ps")
    clear_graphs()
    _numbers_pipeline(P, 20)
    P.run(persistence_config=cfg, max_commits=3)  # stopped early, no finish()
    clear_graphs()
    rows = _numbers_pipeline(P, 20)
    P.run(persistence_config=cfg)
    out = {"final": [int(r["total"]) for r in rows.values()], "journal_rows": P.journal_rows(cfg)}
    assert out == {"final": [sum(range(20))], "journal_rows": 20}
    return out


def case_silent_replay_suppresses_sink_redelivery(P: Pkg, tmp) -> dict:
    cfg = P.fs_config(tmp / "ps", persistence_mode="silent_replay")
    out: dict = {}
    for run in (1, 2):
        clear_graphs()
        log: list = []
        rows = _static_pipeline(P, log)
        P.run(persistence_config=cfg)
        out[f"run{run}"] = {"final": _final(rows), "deliveries": sorted(log)}
    assert len(out["run1"]["final"]) == 2
    # the replayed history was not delivered again, and no new data came
    assert out["run2"] == {"final": [], "deliveries": []}
    return out


_CRASH_SCRIPT = r"""
import json, os, sys
pkg, input_path, out_path, store = sys.argv[1:5]
pw = __import__(pkg)

class Sch(pw.Schema):
    word: str

t = pw.io.csv.read(input_path, schema=Sch, mode="streaming", autocommit_duration_ms=20)
counts = t.groupby(t.word).reduce(t.word, total=pw.reducers.count())
rows = {}

def on_change(key, row, time, is_addition):
    if is_addition:
        rows[repr(key)] = {k: int(v) if hasattr(v, "item") else v for k, v in row.items()}
    else:
        rows.pop(repr(key), None)
    with open(out_path + ".tmp", "w") as f:
        json.dump(list(rows.values()), f)
    os.replace(out_path + ".tmp", out_path)

pw.io.subscribe(counts, on_change)
cfg = pw.persistence.Config(pw.persistence.Backend.filesystem(store), snapshot_interval_ms=10)
pw.run(persistence_config=cfg, **({"device": "cpu"} if pkg == "pathway_tpu_torch" else {}))
"""


def _spawn(args: list, tmp) -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    return subprocess.Popen(
        [sys.executable, *args], env=env, cwd=str(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def _stop(proc: subprocess.Popen) -> str:
    """SIGKILL the child (if still running) and return its stderr's tail."""
    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGKILL)
    _out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    return err.decode(errors="replace")[-2000:]


def _read_totals(path: str) -> dict:
    try:
        with open(path) as f:
            return {r["word"]: r["total"] for r in json.load(f)}
    except (OSError, ValueError):
        return {}


def case_crash_kill_and_restart_wordcount(P: Pkg, tmp) -> dict:
    """Killed with SIGKILL after the first file, restarted after a second
    file came: the totals count every row once."""
    input_dir = tmp / "in"
    input_dir.mkdir()
    out_path = str(tmp / "out.json")
    script = tmp / "prog.py"
    script.write_text(_CRASH_SCRIPT)
    args = [str(script), P.name, str(input_dir), out_path, str(tmp / "store")]
    (input_dir / "a.csv").write_text("word\n" + "\n".join(["cat"] * 5 + ["dog"] * 3) + "\n")
    proc = _spawn(args, tmp)
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while time.monotonic() < deadline and _read_totals(out_path) != {"cat": 5, "dog": 3}:
            assert proc.poll() is None, proc.communicate()[1].decode()[-2000:]
            time.sleep(0.1)
        first = _read_totals(out_path)
        time.sleep(0.5)
    finally:
        err = _stop(proc)
    assert first == {"cat": 5, "dog": 3}, err
    (input_dir / "b.csv").write_text("word\n" + "\n".join(["cat"] * 2 + ["owl"] * 4) + "\n")
    expected = {"cat": 7, "dog": 3, "owl": 4}
    proc = _spawn(args, tmp)
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while time.monotonic() < deadline and _read_totals(out_path) != expected:
            assert proc.poll() is None, proc.communicate()[1].decode()[-2000:]
            time.sleep(0.2)
        time.sleep(0.5)  # nothing more may come
        got = _read_totals(out_path)
    finally:
        err = _stop(proc)
    assert got == expected, err
    return {"first": first, "resumed": got}


def case_segment_skip_on_unchanged_fingerprint(P: Pkg, tmp) -> dict:
    """A crash inside a segment; the segment is unchanged on resume: its
    re-push is skipped, no row twice."""
    store = tmp / "ps"

    def first_run(folded):
        yield ("begin", "fileA", "fp1")
        yield ("row", {"v": 1})
        yield ("state", {"file": "fileA"})
        yield ("begin", "fileB", "fp2")
        yield ("row", {"v": 10})
        yield ("row", {"v": 20})  # the crash comes before fileB's marker

    clear_graphs()
    rows1 = _run_segmented(P, store, first_run, max_commits=30)
    seen: dict = {}

    def resume_run(folded):
        seen["folded"] = folded
        yield ("begin", "fileB", "fp2")
        yield ("row", {"v": 10})
        yield ("row", {"v": 20})
        yield ("row", {"v": 30})
        yield ("state", {"file": "fileB"})

    clear_graphs()
    rows2 = _run_segmented(P, store, resume_run)
    out = {
        "run1": sorted(r["v"] for r in rows1.values()),
        "run2": sorted(r["v"] for r in rows2.values()),
        "folded": seen["folded"],
    }
    assert out == {"run1": [1, 10, 20], "run2": [1, 10, 20, 30], "folded": [{"file": "fileA"}]}
    return out


def case_segment_retract_on_changed_fingerprint(P: Pkg, tmp) -> dict:
    store = tmp / "ps"

    def first_run(folded):
        yield ("begin", "fileB", "fp_old")
        yield ("row", {"v": 10})
        yield ("row", {"v": 20})

    clear_graphs()
    rows1 = _run_segmented(P, store, first_run, max_commits=30)

    def resume_run(folded):
        # the segment changed while the pipeline was down: 10 and 20 go
        yield ("begin", "fileB", "fp_new")
        yield ("row", {"v": 77})
        yield ("state", {"file": "fileB"})

    clear_graphs()
    rows2 = _run_segmented(P, store, resume_run)
    out = {"run1": sorted(r["v"] for r in rows1.values()),
           "run2": sorted(r["v"] for r in rows2.values())}
    assert out == {"run1": [10, 20], "run2": [77]}
    return out


def case_segment_vanished_barrier_retracts_tail(P: Pkg, tmp) -> dict:
    store = tmp / "ps"

    def first_run(folded):
        yield ("begin", "fileB", "fp")
        yield ("row", {"v": 10})

    clear_graphs()
    rows1 = _run_segmented(P, store, first_run, max_commits=30)

    def resume_run(folded):
        # fileB is gone: a full scan pass without it undoes its rows
        yield ("barrier",)

    clear_graphs()
    rows2 = _run_segmented(P, store, resume_run)
    out = {"run1": sorted(r["v"] for r in rows1.values()),
           "run2": sorted(r["v"] for r in rows2.values())}
    assert out == {"run1": [10], "run2": []}
    return out


def case_torn_journal_tail_is_truncated(P: Pkg, tmp) -> dict:
    store = tmp / "ps"
    cfg = P.fs_config(store)
    out: dict = {}
    for run in (1, 2, 3):
        clear_graphs()
        rows = _static_pipeline(P)
        P.run(persistence_config=cfg)
        out[f"run{run}"] = _final(rows)
        if run == 1:
            # a crash while a frame was written: garbage after the last frame
            with open(store / "journal.bin", "ab") as f:
                f.write(b"\x00\x00\x00\x00\x00\x00\x10\x00partialgarbage")
    out["journal_rows"] = P.journal_rows(cfg)
    for run in (1, 2, 3):
        assert {dict(r)["word"] for r in out[f"run{run}"]} == {"cat", "dog"}
    return out


def case_fs_file_modified_while_down(P: Pkg, tmp) -> dict:
    """A file read whole and then modified while the pipeline was down is
    retracted and read again."""
    input_dir = tmp / "in"
    input_dir.mkdir()
    (input_dir / "a.csv").write_text("word\ncat\ncat\n")
    cfg = P.fs_config(tmp / "ps")
    clear_graphs()
    rows1 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    first = _totals(rows1)
    time.sleep(0.05)
    (input_dir / "a.csv").write_text("word\nowl\nowl\nowl\n")
    os.utime(input_dir / "a.csv")
    clear_graphs()
    rows2 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    out = {"run1": first, "run2": _totals(rows2), "journal_rows": P.journal_rows(cfg)}
    assert out["run1"] == {"cat": 2} and out["run2"] == {"owl": 3}
    return out


def case_checkpoint_resume_and_journal_compaction(P: Pkg, tmp) -> dict:
    """Operator state restored from a checkpoint, the journal compacted, the
    sinks given the restored state as one delivery."""
    store = tmp / "ps"
    cfg = P.fs_config(store, snapshot_interval_ms=1)
    clear_graphs()
    rows1 = _numbers_pipeline(P, 10)
    P.run(persistence_config=cfg)
    checkpointed = (store / "checkpoint.pkl").exists()
    journal_bytes = (store / "journal.bin").stat().st_size
    # resumed: the subject pushes 15 values now, the first 10 are skipped
    clear_graphs()
    rows2 = _numbers_pipeline(P, 15)
    P.run(persistence_config=cfg)
    out = {
        "run1": [int(r["total"]) for r in rows1.values()],
        "run2": [int(r["total"]) for r in rows2.values()],
        "checkpointed": checkpointed,
    }
    assert out == {"run1": [sum(range(10))], "run2": [sum(range(15))], "checkpointed": True}
    assert journal_bytes < 10_000
    return out


def case_checkpoint_groupby_state_survives_compaction(P: Pkg, tmp) -> dict:
    """After compaction the journal holds no history: the groupby's
    accumulators come from the checkpoint."""
    input_dir = tmp / "in"
    input_dir.mkdir()
    (input_dir / "a.csv").write_text("word\ncat\ncat\ndog\n")
    cfg = P.fs_config(tmp / "ps", snapshot_interval_ms=1)
    clear_graphs()
    rows1 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    first = _totals(rows1)
    (input_dir / "b.csv").write_text("word\ncat\nowl\n")  # a new file while down
    clear_graphs()
    rows2 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    out = {"run1": first, "run2": _totals(rows2)}
    assert out == {"run1": {"cat": 2, "dog": 1}, "run2": {"cat": 3, "dog": 1, "owl": 1}}
    return out


def case_double_crash_mid_segment_skip_width(P: Pkg, tmp) -> dict:
    """A crash, a resume, a second crash before the marker: the second
    resume skips the whole re-pushed prefix."""
    store = tmp / "ps"

    def run1(folded):
        yield ("begin", "fileB", "fp")
        yield ("row", {"v": 10})
        yield ("row", {"v": 20})

    def run2(folded):
        yield ("begin", "fileB", "fp")
        yield ("row", {"v": 10})
        yield ("row", {"v": 20})
        yield ("row", {"v": 30})  # the second crash comes before the marker

    def run3(folded):
        yield ("begin", "fileB", "fp")
        for v in (10, 20, 30, 40):
            yield ("row", {"v": v})
        yield ("state", {"file": "fileB"})

    for script, max_commits in ((run1, 30), (run2, 30)):
        clear_graphs()
        _run_segmented(P, store, script, max_commits=max_commits)
    clear_graphs()
    rows = _run_segmented(P, store, run3)
    out = {"run3": sorted(r["v"] for r in rows.values())}
    assert out == {"run3": [10, 20, 30, 40]}
    return out


def case_nondet_udf_memo_survives_checkpoint(P: Pkg, tmp) -> dict:
    """A ``deterministic=False`` UDF's replay memo rides the checkpoint: after
    a restore, the retraction of a row from before it carries the original
    value, not a new call's."""
    calls: list = []

    def nondet(x: str) -> str:
        calls.append(x)
        return f"{x}#{len(calls)}"

    def build(rows):
        class Subject:
            def run(self, source):
                for key, value, diff in rows:
                    source.push({"k": value}, key=P.pointer_from(key), diff=diff)

        source = P.StreamingDataSource(subject=Subject(), autocommit_ms=5)
        node = P.G.add_node(P.pg.InputNode(source=source, streaming=True, name="s"))
        t = P.Table(node, P.pw.schema_builder({"k": str}), name="s")
        res = t.select(t.k, v=P.pw.udf(nondet, deterministic=False)(t.k))
        events: list = []
        P.pw.io.subscribe(
            res,
            on_batch=lambda keys, diffs, columns, time: events.extend(
                zip(columns["v"].tolist(), diffs.tolist())
            ),
        )
        return events

    store = tmp / "ps"
    cfg = P.fs_config(store, snapshot_interval_ms=1)
    clear_graphs()
    ev1 = build([("a", "a", 1), ("b", "b", 1)])
    P.run(persistence_config=cfg)
    a_value = next(v for v, d in ev1 if d == 1 and v.startswith("a#"))
    checkpointed = (store / "checkpoint.pkl").exists()
    # the source pushes its first two rows again (skipped) and retracts "a"
    clear_graphs()
    ev2 = build([("a", "a", 1), ("b", "b", 1), ("a", "a", -1)])
    P.run(persistence_config=cfg)
    out = {"a_value": a_value, "retractions": [v for v, d in ev2 if d < 0],
           "checkpointed": checkpointed}
    assert out["checkpointed"] and out["retractions"] == [a_value]
    return out


def case_v1_journal_magic_refused(P: Pkg, tmp) -> dict:
    """A journal of the build before the splitmix key derivation is refused
    loudly: its stored keys no longer match the keys derived now."""
    mgr = P.PersistenceManager(P.fs_config(tmp / "ps_v1"))
    os.makedirs(mgr.root, exist_ok=True)
    with open(os.path.join(str(mgr.root), "journal.bin"), "wb") as f:
        f.write(b"PWTPUJ1\nsome-graph-sig\n")
    with pytest.raises(ValueError, match="incompatible earlier build") as info:
        mgr.load_journal("some-graph-sig")
    return {"error": type(info.value).__name__}


def case_worker_count_mismatch_refused(P: Pkg, tmp) -> dict:
    """A store written by two worker processes, reopened by one, is refused
    instead of resumed from an empty shard."""
    cfg = P.fs_config(tmp / "ps_workers")
    base = P.config.PathwayConfig.from_env()
    P.config.set_thread_config(replace(base, processes=2, process_id=0))
    try:
        writer = P.PersistenceManager(cfg)
        writer.load_journal("sig")
        writer.open_for_append("sig")
        writer.close()
    finally:
        P.config.set_thread_config(None)
    reader = P.PersistenceManager(cfg)
    with pytest.raises(ValueError, match="worker process") as info:
        reader.open_for_append("sig")
    err = info.value
    return {"error": type(err).__name__, "manifest_n": err.manifest_n, "current_n": err.current_n}


def case_same_worker_count_reopens_cleanly(P: Pkg, tmp) -> dict:
    cfg = P.fs_config(tmp / "ps_ok")
    writer = P.PersistenceManager(cfg)
    writer.load_journal("sig")
    writer.open_for_append("sig")
    writer.record_commit(0, {}, {})
    writer.close()
    reader = P.PersistenceManager(cfg)
    frames = reader.load_journal("sig")
    reader.open_for_append("sig")
    reader.close()
    assert len(frames) == 1
    return {"frames": len(frames)}


def case_fs_state_markers_not_duplicated_in_journal(P: Pkg, tmp) -> dict:
    """The fs scanner's markers are slim (file, mtime, row count): the
    journal holds about one copy of the corpus, and the resume still
    rebuilds the rows to retract a file changed while down."""
    input_dir = tmp / "in"
    input_dir.mkdir()
    store = tmp / "ps"
    payload = "word\n" + "\n".join(f"word-{i:05d}-{'x' * 64}" for i in range(500))
    (input_dir / "a.csv").write_text(payload)
    cfg = P.fs_config(store)
    clear_graphs()
    rows1 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    frames = P.PersistenceManager(cfg).load_journal(P.G._current.sig())
    markers = [
        d for _cid, _deltas, offs in frames for o in offs.values()
        for d in o.get("state_deltas", [])
    ]
    assert markers and all("rows" not in d for d in markers), markers
    assert all(d.get("n_rows") == 500 for d in markers if not d.get("deleted"))
    journal_bytes = (store / "journal.bin").stat().st_size
    one_copy = sum(
        len(pickle.dumps({n: c[i] for n, c in d.columns.items()}))
        for _cid, deltas, _offs in frames for d in deltas.values() for i in range(len(d))
    )
    assert journal_bytes < 1.5 * one_copy, (journal_bytes, one_copy)
    time.sleep(0.05)
    (input_dir / "a.csv").write_text("word\nfresh\nfresh\n")
    os.utime(input_dir / "a.csv")
    clear_graphs()
    rows2 = _csv_counts(P, input_dir)
    P.run(persistence_config=cfg)
    out = {"run1": len(rows1), "markers": [sorted(d) for d in markers],
           "run2": _totals(rows2)}
    assert out["run1"] == 500 and out["run2"] == {"fresh": 2}
    return out


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_persistence_case_equals_the_reference(case, tmp_path):
    results = {}
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        try:
            results[name] = CASES[case](Pkg(name), tmp_path / name)
        finally:
            clear_graphs()
    assert results["pathway_tpu_torch"] == results["pathway_tpu"]


def test_every_case_of_the_reference_is_ported():
    """One case here for each test of ``tests/test_persistence.py``."""
    with open(os.path.join(REPO, "tests", "test_persistence.py")) as f:
        names = {line.split("(")[0][len("def test_"):] for line in f if line.startswith("def test_")}
    assert names == set(CASES)


# -- C11: pw.run(persistence_config=...) and PATHWAY_REPLAY_STORAGE take effect ----


def _resume_twice(P: Pkg, input_dir, store, how: str, monkeypatch) -> dict:
    """A static csv read into a groupby, run twice over one store through
    ``pw.run``: the second run resumes from the journal."""
    kwargs = dict(P.run_kw)
    if how == "config":
        kwargs["persistence_config"] = P.fs_config(store)
    else:
        monkeypatch.setenv("PATHWAY_REPLAY_STORAGE", str(store))
    out: dict = {}
    try:
        for run in (1, 2):
            clear_graphs()
            log: list = []
            rows = _csv_counts(P, input_dir, log)
            P.pw.run(**kwargs)
            out[f"run{run}"] = {"totals": _totals(rows), "deliveries": sorted(log)}
    finally:
        monkeypatch.delenv("PATHWAY_REPLAY_STORAGE", raising=False)
    frames = P.PersistenceManager(P.fs_config(store)).load_journal(P.G._current.sig())
    out["journal_rows"] = sum(len(d) for _c, deltas, _o in frames for d in deltas.values())
    # the csv source's restored offsets: what the last frame journaled
    out["offsets"] = sorted(
        (o["consumed"], [sorted(m.items()) for m in o.get("state_deltas", [])])
        for o in frames[-1][2].values() if "consumed" in o
    )
    return out


@pytest.mark.parametrize("how", ["config", "env"])
def test_pw_run_resumes_from_the_journal_as_the_reference(how, tmp_path, monkeypatch):
    """Both ways of asking ``pw.run`` for persistence take effect: the second
    run replays the journal (the sink hears the replayed rows once, the
    journal holds one copy of the input) and does not read the file again."""
    input_dir = tmp_path / "in"
    input_dir.mkdir()
    (input_dir / "a.csv").write_text("word\ncat\ncat\ndog\n")
    results = {}
    for name in PACKAGES:
        results[name] = _resume_twice(Pkg(name), input_dir, tmp_path / f"store-{name}", how,
                                      monkeypatch)
    clear_graphs()
    got = results["pathway_tpu_torch"]
    assert got == results["pathway_tpu"]
    assert got["run1"]["totals"] == got["run2"]["totals"] == {"cat": 2, "dog": 1}
    assert got["journal_rows"] == 3
    assert got["run2"]["deliveries"] == got["run1"]["deliveries"]


# -- a rehearsal of chip_smoke.py's phase 10 against the reference's same program --

_TINY = dict(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
_PHASE = {"chunks": 2048, "files": 16, "queries": 16, "gone_queries": 8}
# bf16 embeddings of the two packages agree at cosine >= 0.999 per row (the
# port's rule for the bf16 encoder), so a top-10 may swap rows whose cosines
# to the query lie within that of the 10th
_TIE = 1e-3

_REF_PHASE = r"""
import json, os, sys, threading
spec = json.load(open(sys.argv[1]))
import pathway_tpu as pw
from pathway_tpu.models.encoder import EncoderConfig
from pathway_tpu.stdlib.ml import KNNIndex
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder

go, answered = threading.Event(), threading.Event()
docs, answers = {}, {}
lock = threading.Lock()

class QueryFeed(pw.io.python.ConnectorSubject):
    def run(self):
        if spec["run"] == 1:
            return
        go.wait()
        for qid, text in enumerate(spec["queries"]):
            self.next(qid=qid, text=text)
        self.commit()

docs_t = pw.io.jsonlines.read(spec["watch"], schema=pw.schema_from_types(cid=int, text=str),
                              mode="streaming", autocommit_duration_ms=None,
                              object_pattern="*.jsonl")
emb = SentenceTransformerEmbedder(sub_batch=1024, encoder_config=EncoderConfig(**spec["tiny"]))
vecs = docs_t.select(docs_t.cid, docs_t.text, vec=emb(docs_t.text))
knn = KNNIndex(vecs.vec, vecs, n_dimensions=emb.get_embedding_dimension(),
               distance_type="cosine", exact=False, approximate="ivf",
               n_clusters=spec["clusters"], n_probe=spec["clusters"])
q = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                      autocommit_duration_ms=None)
res = knn.get_nearest_items_asof_now(q.select(q.qid, qvec=emb(q.text)).qvec, k=spec["k"])
counted = vecs.reduce(n=pw.reducers.count())

def on_vec(key, row, time, is_addition):
    with lock:
        if is_addition:
            docs[repr(key)] = (int(row["cid"]), [float(x) for x in row["vec"]])
        else:
            docs.pop(repr(key), None)
        if spec["run"] == 2 and len(docs) == spec["total"]:
            go.set()

def on_answer(key, row, time, is_addition):
    if is_addition:
        with lock:
            answers[int(row["qid"])] = [int(c) for c in row["cid"]]
            if len(answers) == len(spec["queries"]):
                answered.set()

pw.io.subscribe(vecs, on_vec)
pw.io.subscribe(counted, lambda key, row, time, is_addition: None)
pw.io.subscribe(res, on_answer)

def report():
    answered.wait()
    with lock:
        out = {"vecs": {c: v for c, v in docs.values()}, "answers": answers}
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    os._exit(0)  # the streaming read never ends

threading.Thread(target=report, daemon=True).start()
pw.run(persistence_config=pw.persistence.Config(pw.persistence.Backend.filesystem(spec["store"])))
"""


def _reference_phase(tmp, files: dict, sz: dict, q_texts: list) -> dict:
    """The reference's same program: Run 1 killed with SIGKILL once the
    journal holds ``journaled`` files, the same changes while it is down, and
    Run 2 on the same store, which reports its embeddings and answers."""
    import chip_smoke

    watch, store = tmp / "watch", tmp / "store"
    watch.mkdir()
    for f in range(1, sz["present"] + 1):
        chip_smoke.persist_write(str(watch), f, files[f])
    script = tmp / "ref_phase.py"
    script.write_text(_REF_PHASE)
    total = (sz["files"] - 1) * (sz["chunks"] // sz["files"])
    base = {"watch": str(watch), "store": str(store), "tiny": _TINY, "k": sz["k"],
            "clusters": sz["clusters"], "queries": q_texts, "total": total,
            "out": str(tmp / "ref_out.json")}
    for run in (1, 2):
        spec = tmp / f"spec{run}.json"
        spec.write_text(json.dumps({**base, "run": run}))
        proc = _spawn([str(script), str(spec)], tmp)
        try:
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            if run == 1:
                while len(chip_smoke.journaled_files(str(store))[0]) < sz["journaled"]:
                    assert proc.poll() is None and time.monotonic() < deadline, (
                        proc.communicate()[1].decode()[-3000:] if proc.poll() is not None else "")
                    time.sleep(0.01)
            else:
                proc.wait(CHILD_TIMEOUT_S)
        finally:
            err = _stop(proc)
        if run == 1:
            for f in range(sz["present"] + 1, sz["files"] + 1):
                chip_smoke.persist_write(str(watch), f, files[f])
            chip_smoke.persist_write(str(watch), sz["rewritten"], files["rewritten"])
            os.unlink(watch / f"part{sz['deleted']:02d}.jsonl")
    assert (tmp / "ref_out.json").exists(), err
    with open(tmp / "ref_out.json") as f:
        out = json.load(f)
    return {"vecs": {int(c): np.asarray(v) for c, v in out["vecs"].items()},
            "answers": {int(q): a for q, a in out["answers"].items()}}


def test_phase10_rehearsal_equals_the_reference(tmp_path, monkeypatch):
    """``chip_smoke.run_persist`` on the CPU at 2,048 chunks with a 2-layer
    encoder carrying the reference's weights (its checks run as on the card:
    exactly the final corpus, the files read again, top-1 hits, no deleted
    chunk), then the reference's same program: embeddings at cosine >= 0.999
    per chunk, the same top-1 and top-10 sets bar near ties."""
    import types

    import jax
    import torch

    from pathway_tpu.models.encoder import EncoderConfig as RefConfig
    from pathway_tpu.models.encoder import JaxSentenceEncoder
    from pathway_tpu_torch.models.encoder import EncoderConfig

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    ref_enc = JaxSentenceEncoder(config=RefConfig(**_TINY))
    params_path = tmp_path / "params.pkl"
    with open(params_path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, ref_enc.params), f)
    sz = {**chip_smoke.PERSIST, **_PHASE}
    per = sz["chunks"] // sz["files"]
    docs = chip_smoke.make_corpus(sz["chunks"] + per, 0)
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "port"))  # the phase's directory
    out, launches = chip_smoke.run_persist(
        torch, types.SimpleNamespace(seed=0), "cpu", docs, device="cpu",
        encoder_config=EncoderConfig(**_TINY), sizes=_PHASE, params=str(params_path),
    )
    assert out["final_chunks"] == 15 * per
    assert 4 <= len(out["run1"]["journaled_files"]) < 8
    assert out["run2"]["replay_rows"] == out["run1"]["journal_rows"]
    got = out["rehearsal"]
    (tmp_path / "ref").mkdir()
    want = _reference_phase(tmp_path / "ref", chip_smoke.persist_files(docs, sz), sz,
                            got["queries"])
    assert set(got["vecs"]) == set(want["vecs"])
    cos = [
        float(np.dot(got["vecs"][c], v) / (np.linalg.norm(got["vecs"][c]) * np.linalg.norm(v)))
        for c, v in want["vecs"].items()
    ]
    assert min(cos) >= 0.999, min(cos)
    for qid in range(got["hits"]):
        mine = [c for c, _s in got["answers"][qid]]
        theirs = want["answers"][qid]
        assert mine[0] == theirs[0], (qid, mine, theirs)
        q = got["vecs"][mine[0]]  # the query is this chunk's exact text

        def cosine(c):
            v = got["vecs"][c]
            return float(np.dot(q, v) / (np.linalg.norm(q) * np.linalg.norm(v)))

        kth = min(cosine(c) for c in mine)
        for c in set(mine) ^ set(theirs):
            assert abs(cosine(c) - kth) <= _TIE, (qid, c, cosine(c), kth)
    gone = {r["cid"] for r in chip_smoke.persist_files(docs, sz)[sz["rewritten"]]}
    gone |= {r["cid"] for r in chip_smoke.persist_files(docs, sz)[sz["deleted"]]}
    for qid in range(got["hits"], len(got["queries"])):
        assert not gone & set(want["answers"][qid])
