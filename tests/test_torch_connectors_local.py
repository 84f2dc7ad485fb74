"""The connectors that need no client package, held against the reference's:
the cross-graph handoff (``pw.io.export_table`` / ``import_table`` /
``ExportedTable``: the reference's six ``export_*`` cases of
``tests/test_export_debezium.py``, run on both packages), ``pw.io.sqlite``
static and streaming, ``pw.io.pyfilesystem`` over a fake FS object,
``io/_utils.plain_row``, and the two engine hooks the handoff needs: an
exporting graph's failure reaches its importers (``notify_failure``), and an
importer whose exporter never closes stops at ``finish`` (``stop``).

A streaming read never ends and the reference's runner has no stop, so the
streaming parity cases run each package's read in a child process, which
prints the update stream and is killed once it has shown the change."""

from __future__ import annotations

import json
import os
import queue
import sqlite3
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.internals import parse_graph as ref_pg
from pathway_tpu_torch.internals import parse_graph as pg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": ref_pw, "port": pw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    # the port has no operator fusion: the reference runs its per-node dispatch
    monkeypatch.setenv("PATHWAY_FUSION", "off")
    ref_pg.G.clear()
    for attr in ("_global_error_log", "_error_log_source", "_error_log_stack"):
        ref_pg.G._current.__dict__.pop(attr, None)
    pg.G.clear()
    graphs = (ref_pg.G._current, pg.G._current)
    yield
    ref_pg.G._current, pg.G._current = graphs
    ref_pg.G.clear()
    pg.G.clear()


def _graph_mod(pkg):
    return ref_pg if pkg is ref_pw else pg


def _runner(pkg):
    if pkg is ref_pw:
        from pathway_tpu.engine.runner import GraphRunner
    else:
        from pathway_tpu_torch.engine.runner import GraphRunner
    return GraphRunner


def _run_graph(pkg, graph) -> None:
    kwargs = {"monitoring_level": pkg.MonitoringLevel.NONE}
    if pkg is pw:
        kwargs["device"] = "cpu"
    _runner(pkg)(graph).run(**kwargs)


def _run(pkg) -> None:
    kwargs = {"monitoring_level": pkg.MonitoringLevel.NONE}
    if pkg is pw:
        kwargs["device"] = "cpu"
    pkg.run(**kwargs)


# ---------------------------------------------------------------------------
# the reference's export_* cases, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_import_cross_graph_handoff(name):
    """Graph A (background) exports; graph B imports snapshot + live updates."""
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    rows = [
        ("a", 1, 0, 1),
        ("b", 2, 2, 1),
        ("a", 1, 4, -1),  # retraction must propagate into the importing graph
        ("c", 3, 4, 1),
    ]
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"k": str, "v": int}), rows, is_stream=True
    )
    exported = pw_.io.export_table(src)
    graph_a = G._current
    ta = threading.Thread(target=lambda: _run_graph(pw_, graph_a))
    ta.start()
    ta.join(timeout=30)
    assert not ta.is_alive()
    assert exported.frontier() >= 0
    snap = exported.snapshot_at(exported.frontier())
    assert sorted((r["k"], r["v"]) for _p, r in snap) == [("b", 2), ("c", 3)]

    # importing graph: mounts the finished export (snapshot then stream end)
    G.clear()
    imported = pw_.io.import_table(exported)
    total = imported.reduce(s=pw_.reducers.sum(pw_.this.v))
    got = []
    pw_.io.subscribe(
        total,
        on_batch=lambda keys, diffs, columns, time: got.extend(
            zip(columns["s"].tolist(), diffs.tolist())
        ),
    )
    _run(pw_)
    live = [v for v, d in got if d > 0][-1]
    assert live == 5  # b + c

    # original row keys preserved across the handoff
    keys_a = {repr(p) for p, _r in snap}
    G.clear()
    imported2 = pw_.io.import_table(exported)
    seen_keys = set()
    pw_.io.subscribe(
        imported2,
        lambda key, row, time, is_addition: seen_keys.add(repr(key)),
    )
    _run(pw_)
    assert keys_a <= seen_keys


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_live_streaming_updates(name):
    """An importer subscribed BEFORE the exporter finishes sees live deltas."""
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"v": int}),
        [(1, 0, 1), (2, 2, 1), (3, 4, 1)],
        is_stream=True,
    )
    exported = pw_.io.export_table(src)
    graph_a = G._current
    events = []
    done = threading.Event()

    def listener(batch, time):
        if batch is None:
            done.set()
        else:
            events.extend(batch)

    exported.subscribe(listener)
    _run_graph(pw_, graph_a)
    assert done.wait(timeout=10)
    assert sorted(r["v"] for _p, r, d in events if d > 0) == [1, 2, 3]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_failure_propagates_to_importer(name):
    """A failing exporting graph must NOT look like a clean close to importers."""
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"v": int}), [(1, 0, 1), (2, 2, 1)], is_stream=True
    )

    def boom(x: int) -> int:
        raise RuntimeError("exporter exploded")

    bad = src.select(v=pw_.udf(boom)(pw_.this.v))
    exported = pw_.io.export_table(bad)
    graph_a = G._current
    with pytest.raises(Exception, match="exporter exploded"):
        _run_graph(pw_, graph_a)
    assert exported.failed()

    G.clear()
    imported = pw_.io.import_table(exported)
    pw_.io.subscribe(imported, lambda *a, **kw: None)
    with pytest.raises(Exception, match="exporting graph failed"):
        _run(pw_)


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_listener_may_reenter_public_api(name):
    """Listeners run under the export lock but the lock is reentrant: calling
    frontier()/snapshot_at() from inside a listener must not deadlock."""
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"v": int}), [(1, 0, 1), (2, 2, 1)], is_stream=True
    )
    exported = pw_.io.export_table(src)
    frontiers = []

    def listener(batch, time):
        frontiers.append(exported.frontier())  # re-entrant call under the lock

    exported.subscribe(listener)
    _run_graph(pw_, G._current)
    assert len(frontiers) >= 2


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_reentrant_subscribe_no_double_delivery(name):
    """A listener subscribing ANOTHER listener mid-batch must not double-deliver
    the in-flight batch to the newcomer (snapshot already includes it)."""
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"v": int}), [(1, 0, 1), (2, 2, 1)], is_stream=True
    )
    exported = pw_.io.export_table(src)
    second_events = []

    def second(batch, time):
        if batch is not None:
            second_events.extend(batch)

    subscribed = []

    def first(batch, time):
        if batch is not None and not subscribed:
            subscribed.append(True)
            exported.subscribe(second)

    exported.subscribe(first)
    _run_graph(pw_, G._current)
    # each row delivered exactly once to the late subscriber
    vals = sorted(r["v"] for _p, r, d in second_events if d > 0)
    assert vals == [1, 2]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_export_snapshot_future_frontier_in_listener_raises(name):
    pw_, G = PKGS[name], _graph_mod(PKGS[name]).G
    src = pw_.debug.table_from_rows(
        pw_.schema_builder({"v": int}), [(1, 0, 1)], is_stream=True
    )
    exported = pw_.io.export_table(src)
    caught = []

    def listener(batch, time):
        if batch is not None:
            try:
                exported.snapshot_at(time + 1000)
            except RuntimeError as exc:
                caught.append(str(exc))

    exported.subscribe(listener)
    _run_graph(pw_, G._current)
    assert caught and "deadlock" in caught[0]


# ---------------------------------------------------------------------------
# the engine hooks the handoff needs
# ---------------------------------------------------------------------------


def test_failing_run_calls_on_error_before_on_end():
    """``notify_failure`` reaches every sink's ``on_error`` on the crash path,
    once, before ``finish`` fires ``on_end``; a clean run never calls it."""
    calls = []

    def program(fail: bool):
        pg.G.clear()
        src = pw.debug.table_from_rows(pw.schema_builder({"v": int}), [(1, 0, 1), (2, 2, 1)],
                                       is_stream=True)

        def f(x: int) -> int:
            if fail and x == 2:
                raise RuntimeError("sink input exploded")
            return x

        out = src.select(v=pw.udf(f)(pw.this.v))
        for sink in ("a", "b"):
            pg.G.add_node(pg.OutputNode(
                inputs=[out], batch_callback=lambda *a: None,
                on_error=lambda exc, sink=sink: calls.append((sink, "error", str(exc))),
                on_end=lambda sink=sink: calls.append((sink, "end")),
            ))

    program(fail=False)
    _run(pw)
    assert sorted(calls) == [("a", "end"), ("b", "end")]
    calls.clear()
    program(fail=True)
    with pytest.raises(Exception, match="sink input exploded"):
        _run(pw)
    for sink in ("a", "b"):
        mine = [c[1] for c in calls if c[0] == sink]
        assert mine == ["error", "end"], calls
    assert all("sink input exploded" in c[2] for c in calls if c[1] == "error")


@pytest.mark.parametrize("name", sorted(PKGS))
def test_importer_returns_at_finish_with_an_exporter_that_never_closes(name):
    """Stopping the importing graph while its exporter runs on: ``finish``
    calls the import subject's ``stop``, so its connector thread returns
    instead of parking forever on the export."""
    pw_ = PKGS[name]
    G = _graph_mod(pw_).G
    release = threading.Event()

    class Never(pw_.io.python.ConnectorSubject):
        def run(self):
            for v in (1, 2, 3):
                self.next(v=v)
            self.commit()
            release.wait(30)

    src = pw_.io.python.read(Never(), schema=pw_.schema_from_types(v=int),
                             autocommit_duration_ms=None)
    exported = pw_.io.export_table(src)
    graph_a = G._current
    ta = threading.Thread(target=lambda: _run_graph(pw_, graph_a), daemon=True)
    ta.start()
    try:
        exported.snapshot_at(0, timeout=20)
        # the importing graph is built beside the running one (a clear
        # would empty the running graph in place)
        G._current = _graph_mod(pw_).ParseGraph()
        imported = pw_.io.import_table(exported)
        seen = []
        pw_.io.subscribe(imported, lambda key, row, time, is_addition: seen.append(row["v"]))
        graph_b = G._current
        runner_b = _runner(pw_)(graph_b)
        kwargs = {"monitoring_level": pw_.MonitoringLevel.NONE}
        if pw_ is pw:
            kwargs["device"] = "cpu"
        tb = threading.Thread(target=lambda: runner_b.run(**kwargs), daemon=True)
        tb.start()
        deadline = time.monotonic() + 20
        while len(seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(seen) == [1, 2, 3]
        (source,) = [n.config["source"] for n in graph_b.nodes
                     if isinstance(n, _graph_mod(pw_).InputNode)]
        if pw_ is pw:
            runner_b.stop()
        else:
            # the reference's runner has no stop: its finish is what the
            # port's stop ends in
            runner_b.finish()
        tb.join(20)
        source._thread.join(10)
        assert not source._thread.is_alive(), "the import thread parked on the export"
        if pw_ is pw:
            assert not tb.is_alive()
        assert not exported._closed  # the exporter never closed
    finally:
        release.set()
        ta.join(20)
    assert exported._closed


# ---------------------------------------------------------------------------
# sqlite and pyfilesystem: static in process, streaming in child processes
# ---------------------------------------------------------------------------

_STREAM = r"""
import json, os, sys
pkg, kind, arg = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
if pkg == "port":
    import pathway_tpu_torch as pw
    kwargs = {"device": "cpu"}
else:
    import pathway_tpu as pw
    kwargs = {}


class Walk:
    def __init__(self, root):
        self.root = root

    def files(self, path="/"):
        return sorted("/" + n for n in os.listdir(self.root) if not n.startswith("."))


class DirFS:
    def __init__(self, root):
        self.root = root
        self.walk = Walk(root)

    def readbytes(self, path):
        with open(os.path.join(self.root, path.lstrip("/")), "rb") as f:
            return f.read()


if kind == "sqlite":
    t = pw.io.sqlite.read(arg["path"], "chunks", pw.schema_from_types(doc_id=int, text=str),
                          mode="streaming", autocommit_duration_ms=20)
    if arg.get("ix"):
        # a table read by ``ix`` is kept by the engine: retractions must
        # carry the keys their rows hold
        t = t.select(t.doc_id, again=t.ix(t.id).text)
else:
    t = pw.io.pyfilesystem.read(DirFS(arg["root"]), refresh_interval=0.1)


def show(v):
    return v.hex() if isinstance(v, bytes) else v


def on_change(key, row, time, is_addition):
    print(json.dumps([key.as_int(), sorted((k, show(v)) for k, v in row.items()),
                      1 if is_addition else -1]), flush=True)


pw.io.subscribe(t, on_change)
print("started", flush=True)
pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kwargs)
"""


def _child(pkg: str, kind: str, arg: dict):
    """The child process and a ``take(n)`` of its next ``n`` events."""
    env = {**os.environ, "PATHWAY_FUSION": "off", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, "-c", _STREAM, pkg, kind, json.dumps(arg)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=env)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()

    def take(n: int) -> list:
        out = []
        while len(out) < n:
            try:
                line = lines.get(timeout=90)
            except queue.Empty:
                proc.kill()
                raise AssertionError(f"{pkg} {kind}: {len(out)} of {n} events; "
                                     f"{proc.stderr.read()[-2000:]}") from None
            if line.startswith("["):
                event = json.loads(line)
                out.append((event[0], tuple(tuple(p) for p in event[1]), event[2]))
        return out

    return proc, lines, take


def _streaming_events(pkg: str, kind: str, arg: dict, first: int, change, second: int):
    """The child's update stream: ``first`` events, then ``change()``, then
    ``second`` more; the child is killed after."""
    proc, lines, take = _child(pkg, kind, arg)
    try:
        before = take(first)
        change()
        after = take(second)
        # nothing more comes: the change is whole
        time.sleep(0.6)
        extra = []
        while not lines.empty():
            line = lines.get()
            if line.startswith("["):
                extra.append(line)
        assert not extra, extra
    finally:
        proc.kill()
        proc.wait(30)
    return sorted(before), sorted(after)


def _make_db(path: str, n: int) -> None:
    with sqlite3.connect(path) as conn:
        conn.execute("CREATE TABLE chunks (doc_id INTEGER, text TEXT)")
        conn.executemany("INSERT INTO chunks VALUES (?, ?)",
                         [(i, f"chunk {i} text") for i in range(n)])
    conn.close()


def _change_db(path: str) -> None:
    """One transaction: an update, a delete and an insert."""
    conn = sqlite3.connect(path)
    with conn:
        conn.execute("UPDATE chunks SET text = 'chunk 1 rewritten' WHERE doc_id = 1")
        conn.execute("DELETE FROM chunks WHERE doc_id = 3")
        conn.execute("INSERT INTO chunks VALUES (100, 'chunk 100 new')")
    conn.close()


def _final_rows(pkg, table) -> list:
    out = []
    pkg.io.subscribe(table, lambda key, row, time, is_addition: out.append(
        (key.as_int(), tuple(sorted(row.items())), 1 if is_addition else -1)))
    _run(pkg)
    return sorted(out)


def test_sqlite_static_equals_the_reference(tmp_path):
    path = str(tmp_path / "db.sqlite")
    _make_db(path, 12)
    got = {}
    for name, pkg in PKGS.items():
        _graph_mod(pkg).G.clear()
        t = pkg.io.sqlite.read(path, "chunks", pkg.schema_from_types(doc_id=int, text=str),
                               mode="static")
        got[name] = _final_rows(pkg, t)
    assert got["port"] == got["ref"]
    assert sorted(dict(r)["doc_id"] for _k, r, d in got["port"]) == list(range(12))


def test_sqlite_streaming_update_delete_insert_equals_the_reference(tmp_path):
    """The same update stream as the reference's: the same rows and diffs,
    and the same keys on every insertion. A retraction carries the key its
    row was inserted under in the port; the reference's takes a fresh key
    that no row holds (a fault of the reference, below)."""
    streams = {}
    for name in ("ref", "port"):
        path = str(tmp_path / f"{name}.sqlite")
        _make_db(path, 8)
        streams[name] = _streaming_events(name, "sqlite", {"path": path}, 8,
                                          lambda path=path: _change_db(path), 4)
    (ref_before, ref_after), (before, after) = streams["ref"], streams["port"]
    assert before == ref_before
    assert all(d == 1 for *_r, d in before)
    assert [e for e in after if e[2] == 1] == [e for e in ref_after if e[2] == 1]
    assert sorted((r, d) for _k, r, d in after) == sorted((r, d) for _k, r, d in ref_after)
    # the changed row -1 then +1, the deleted row -1, the inserted row +1
    assert sorted((d, dict(r)["doc_id"], dict(r)["text"]) for _k, r, d in after) == [
        (-1, 1, "chunk 1 text"), (-1, 3, "chunk 3 text"),
        (1, 1, "chunk 1 rewritten"), (1, 100, "chunk 100 new")]
    inserted_under = {r: k for k, r, _d in before}
    assert all(k == inserted_under[r] for k, r, d in after if d < 0)
    ref_keys = {k for k, _r, _d in ref_before + ref_after if _d > 0}
    assert not any(k in ref_keys for k, _r, d in ref_after if d < 0)


def test_sqlite_streaming_into_a_kept_table_where_the_reference_fails(tmp_path):
    """Below a table the engine keeps (read by ``ix``), an update and a
    delete go through in the port; the reference's run fails at them with
    ``retraction of absent key``."""
    path = str(tmp_path / "port.sqlite")
    _make_db(path, 8)
    before, after = _streaming_events("port", "sqlite", {"path": path, "ix": True}, 8,
                                      lambda: _change_db(path), 4)
    assert sorted((d, dict(r)["doc_id"], dict(r)["again"]) for _k, r, d in after) == [
        (-1, 1, "chunk 1 text"), (-1, 3, "chunk 3 text"),
        (1, 1, "chunk 1 rewritten"), (1, 100, "chunk 100 new")]
    path = str(tmp_path / "ref.sqlite")
    _make_db(path, 8)
    proc, _lines, take = _child("ref", "sqlite", {"path": path, "ix": True})
    try:
        assert len(take(8)) == 8
        _change_db(path)
        proc.wait(60)
    finally:
        proc.kill()
        proc.wait(30)
    assert proc.returncode != 0
    assert "retraction of absent key" in proc.stderr.read()


class _Walk:
    def __init__(self, files: dict):
        self._files = files

    def files(self, path: str = "/") -> list:
        return sorted(p for p in self._files if p.startswith(path))


class FakeFS:
    """The two calls of the ``fs.FS`` interface the connector uses."""

    def __init__(self, files: dict):
        self._files = files
        self.walk = _Walk(files)

    def readbytes(self, path: str) -> bytes:
        return self._files[path]


FILES = {"/a.txt": b"alpha", "/dir/b.bin": bytes(range(7)), "/dir/c.txt": b"", "/z": b"zz"}


@pytest.mark.parametrize("mode", ["static", "batch"])
def test_pyfilesystem_static_equals_the_reference(mode):
    got = {}
    for name, pkg in PKGS.items():
        _graph_mod(pkg).G.clear()
        t = pkg.io.pyfilesystem.read(FakeFS(dict(FILES)), mode=mode)
        assert list(t.schema.column_names()) == ["data", "path"]
        got[name] = _final_rows(pkg, t)
    assert got["port"] == got["ref"]
    assert sorted((dict(r)["path"], dict(r)["data"]) for _k, r, d in got["port"]) == sorted(
        (p, b) for p, b in FILES.items())


def test_pyfilesystem_refuses_a_non_fs_object_as_the_reference_does():
    for pkg in PKGS.values():
        with pytest.raises(TypeError, match="PyFilesystem FS object"):
            pkg.io.pyfilesystem.read(object())
    with pytest.raises(TypeError) as ref_exc:
        ref_pw.io.pyfilesystem.read("/tmp")
    with pytest.raises(TypeError) as port_exc:
        pw.io.pyfilesystem.read("/tmp")
    assert str(port_exc.value) == str(ref_exc.value)


def test_pyfilesystem_streaming_changed_file_equals_the_reference(tmp_path):
    def write(root: str, name: str, data: bytes) -> None:
        tmp = os.path.join(root, "." + name)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(root, name))

    streams = {}
    for name in ("ref", "port"):
        root = str(tmp_path / name)
        os.makedirs(root)
        for f, data in (("a.txt", b"alpha"), ("b.txt", b"beta")):
            write(root, f, data)

        def change(root=root):
            write(root, "a.txt", b"alpha v2")
            write(root, "c.txt", b"gamma")

        streams[name] = _streaming_events(name, "pyfilesystem", {"root": root}, 2, change, 3)
    assert streams["port"] == streams["ref"]
    _before, after = streams["port"]
    assert sorted((d, dict(r)["path"], bytes.fromhex(dict(r)["data"])) for _k, r, d in after) == [
        (-1, "/a.txt", b"alpha"), (1, "/a.txt", b"alpha v2"), (1, "/c.txt", b"gamma")]


# ---------------------------------------------------------------------------
# io/_utils
# ---------------------------------------------------------------------------


def test_plain_row_equals_the_reference():
    from pathway_tpu.internals.json import Json as RefJson
    from pathway_tpu.internals.keys import pointer_from as ref_pointer_from
    from pathway_tpu.io._utils import plain_row as ref_plain_row
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.keys import pointer_from
    from pathway_tpu_torch.io._utils import plain_row

    def row(J, ptr):
        return {"j": J({"a": [1, 2], "b": None}), "i": np.int64(7), "f": np.float32(0.5),
                "b": np.bool_(True), "p": ptr("doc", 3), "s": "text", "n": None,
                "t": (1, "x"), "raw": b"\x00\x01"}

    want = ref_plain_row(row(RefJson, ref_pointer_from))
    got = plain_row(row(Json, pointer_from))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert got["j"] == {"a": [1, 2], "b": None} and got["p"].startswith("^")


def test_add_batched_sink_batches_and_flushes_as_the_reference():
    from pathway_tpu.io._utils import add_batched_sink as ref_add
    from pathway_tpu_torch.io._utils import add_batched_sink

    got = {}
    for name, pkg, add in (("ref", ref_pw, ref_add), ("port", pw, add_batched_sink)):
        _graph_mod(pkg).G.clear()
        src = pkg.debug.table_from_rows(
            pkg.schema_builder({"v": int}),
            [(v, 2 * (v // 3), 1) for v in range(7)] + [(0, 8, -1)], is_stream=True)
        calls: list = []

        class Client:
            def close(self, calls=calls):
                calls.append("close")

        add(src, lambda rows, calls=calls: calls.append(
            sorted((r["v"], r["time"], r["diff"]) for r in rows)),
            max_batch_size=2, client=Client())
        _run(pkg)
        got[name] = calls
    assert got["port"] == got["ref"]
    assert got["port"][-1] == "close"
