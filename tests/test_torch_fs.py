"""The port's filesystem connectors against the reference's, and the engine's
programs with the native tables off.

- Static reads through ``io.csv`` / ``io.jsonlines`` / ``io.plaintext`` /
  ``io.fs`` (csv, json, plaintext, plaintext_by_file, binary; with and
  without ``_metadata``) give the reference's rows, keys and ``ERROR`` cells,
  natively and with ``PATHWAY_TPU_DISABLE_NATIVE``.
- A streaming read, while ``pw.run`` runs, sees a file added, changed and
  deleted: each package runs in a process of its own and writes its update
  stream, and the two streams carry the same (key, row, diff) changes.
- ``io.csv.write`` / ``io.jsonlines.write`` / ``io.null.write`` write the
  reference's lines.
- The update streams of ``test_torch_engine.py``'s programs (groupby, join,
  ix, flatten, ...) with the native tables off equal the reference's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu.native as ref_native
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_table as ref_capture_table
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_table as capture_table
from pathway_tpu_torch.engine.columnar import ERROR
from pathway_tpu_torch.internals.parse_graph import G

from .test_torch_engine import PROGRAMS, _both

REF_LIB = ref_native.get_lib()  # loaded before a test disables the port's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (ref_pw.Json, pw.Json)):
        value = v.value
        if isinstance(value, dict):  # the seen_at of _metadata is a wall clock
            value = {k: x for k, x in value.items() if k != "seen_at"}
        return ("json", json.dumps(value, sort_keys=True))
    if type(v).__name__ == "Error":
        return "ERROR"
    if isinstance(v, np.generic):
        return v.item()
    return v


def _rows(captured: dict) -> list:
    return sorted(
        (tuple(sorted((k, repr(_norm(x))) for k, x in row.items())) for row in captured.values()),
    )


CSV = (
    'word,count,ok,score,meta\n"a,b",notanint,true,1.5,"{""k"": 1}"\n'
    "c,5,False,bad,[1]\n,,,,\nq,7,1,2e3,notjson\n"
)


def _write_files(d) -> None:
    (d / "csv").mkdir()
    (d / "csv" / "a.csv").write_text(CSV)
    (d / "csv" / "b.csv").write_text("word,count,ok,score,meta\nz,1,0,0.25,null\n")
    (d / "jl").mkdir()
    (d / "jl" / "a.jsonl").write_text(
        '{"word": "x", "count": 3, "meta": {"a": [1, 2]}}\n\n{"word": "y", "count": null}\n'
    )
    (d / "txt").mkdir()
    (d / "txt" / "a.txt").write_text("first line\nsecond, line\n\nlast")
    (d / "txt" / "b.txt").write_text("ünï\n")


def _read(p, kind: str, d, with_metadata: bool):
    if kind == "csv":
        schema = p.schema_from_types(word=str, count=int, ok=bool, score=float, meta=p.Json)
        return p.io.csv.read(str(d / "csv"), schema=schema, mode="static",
                             with_metadata=with_metadata)
    if kind == "csv_semicolon":
        schema = p.schema_from_types(word=str, count=int)
        settings = p.io.csv.CsvParserSettings(delimiter=";")
        return p.io.csv.read(str(d / "semi.csv"), schema=schema, mode="static",
                             csv_settings=settings)
    if kind == "jsonlines":
        schema = p.schema_from_types(word=str, count=int, meta=p.Json)
        return p.io.jsonlines.read(str(d / "jl"), schema=schema, mode="static",
                                   with_metadata=with_metadata)
    if kind == "plaintext":
        return p.io.plaintext.read(str(d / "txt"), mode="static", with_metadata=with_metadata)
    if kind == "plaintext_by_file":
        return p.io.fs.read(str(d / "txt"), format="plaintext_by_file", mode="static")
    if kind == "binary":
        return p.io.fs.read(str(d / "txt" / "*.txt"), format="binary", mode="static")
    raise ValueError(kind)


def _both_reads(kind: str, d, with_metadata: bool = False) -> tuple:
    REF_G.clear()
    want = _rows(ref_capture_table(_read(ref_pw, kind, d, with_metadata)))
    REF_G.clear()
    G.clear()
    got = _rows(capture_table(_read(pw, kind, d, with_metadata), device="cpu"))
    G.clear()
    return want, got


KINDS = ["csv", "csv_semicolon", "jsonlines", "plaintext", "plaintext_by_file", "binary"]


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", KINDS)
def test_static_reads_equal_the_reference(tmp_path, monkeypatch, kind, native_on):
    _write_files(tmp_path)
    (tmp_path / "semi.csv").write_text("word;count\n\"a;b\";1\nc;x\n")
    if not native_on:
        monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    want, got = _both_reads(kind, tmp_path)
    assert got == want
    assert len(got) > 0


@pytest.mark.parametrize("kind", ["csv", "jsonlines", "plaintext"])
def test_metadata_column_equals_the_reference(tmp_path, kind):
    _write_files(tmp_path)
    want, got = _both_reads(kind, tmp_path, with_metadata=True)
    assert got == want
    assert all(any(k == "_metadata" for k, _ in row) for row in got)


def test_csv_cells_coerce_and_poison_like_the_reference(tmp_path):
    _write_files(tmp_path)
    G.clear()
    schema = pw.schema_from_types(word=str, count=int, ok=bool, score=float, meta=pw.Json)
    rows = capture_table(
        pw.io.csv.read(str(tmp_path / "csv" / "a.csv"), schema=schema, mode="static"),
        device="cpu",
    )
    G.clear()
    by_word = {r["word"]: r for r in rows.values()}
    assert by_word["a,b"]["count"] is ERROR and by_word["a,b"]["ok"] is True
    assert by_word["a,b"]["meta"].value == {"k": 1}
    assert by_word["c"]["score"] is ERROR and by_word["c"]["count"] == 5
    assert by_word["q"]["meta"] is ERROR and by_word["q"]["score"] == 2000.0


def test_schema_is_required_for_csv():
    with pytest.raises(ValueError, match="schema is required"):
        pw.io.csv.read("/nonexistent", mode="static")


# -- streaming ------------------------------------------------------------------

_STREAM_PROGRAM = r"""
import json, sys
pkg, path, fmt, out = sys.argv[1:5]
pw = __import__(pkg)
log = open(out, "a")
if fmt == "csv":
    t = pw.io.csv.read(path, schema=pw.schema_from_types(word=str, count=int),
                       mode="streaming", autocommit_duration_ms=20)
elif fmt == "jsonlines":
    t = pw.io.jsonlines.read(path, schema=pw.schema_from_types(word=str, count=int),
                             mode="streaming", autocommit_duration_ms=20)
else:
    t = pw.io.plaintext.read(path, mode="streaming", autocommit_duration_ms=20)

def on_change(key, row, time, is_addition):
    log.write(json.dumps([key.as_int(), sorted(row.items()), 1 if is_addition else -1]) + "\n")
    log.flush()

pw.io.subscribe(t, on_change)
pw.run(**({"device": "cpu"} if pkg == "pathway_tpu_torch" else {}))
"""

_FILES = {
    "csv": ("a.csv", "word,count\nx,1\ny,2\n", "word,count\nx,1\ny,5\nz,6\n", "b.csv",
            "word,count\nw,9\n"),
    "jsonlines": ("a.jsonl", '{"word": "x", "count": 1}\n{"word": "y", "count": 2}\n',
                  '{"word": "x", "count": 1}\n{"word": "y", "count": 5}\n{"word": "z", "count": 6}\n',
                  "b.jsonl",
                  '{"word": "w", "count": 9}\n'),
    "plaintext": ("a.txt", "x\ny\n", "x\ny changed\nz\n", "b.txt", "w\n"),
}


def _read_log(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def _wait_for(logs, count: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(len(_read_log(p)) >= count for p in logs):
            return
        time.sleep(0.05)
    raise AssertionError(f"expected {count} updates: {[len(_read_log(p)) for p in logs]}")


@pytest.mark.parametrize("fmt", ["csv", "jsonlines", "plaintext"])
def test_streaming_read_sees_a_file_added_changed_and_deleted(tmp_path, fmt):
    first, v1, v2, second, other = _FILES[fmt]
    data = tmp_path / "data"
    data.mkdir()
    (data / first).write_text(v1)
    script = tmp_path / "stream.py"
    script.write_text(_STREAM_PROGRAM)
    logs = [str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), pkg, str(data), fmt, log],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        for pkg, log in zip(("pathway_tpu", "pathway_tpu_torch"), logs)
    ]
    try:
        _wait_for(logs, 2)  # the first file's two rows
        time.sleep(1.2)  # past the mtime's resolution and one poll
        # changed: its unchanged first row cancels within the commit, the
        # second is retracted and two rows are new
        (data / first).write_text(v2)
        _wait_for(logs, 5)
        (data / second).write_text(other)  # added
        _wait_for(logs, 6)
        (data / first).unlink()  # deleted: retract its three rows
        _wait_for(logs, 9)
        time.sleep(1.0)  # nothing more may come
    finally:
        for p in procs:
            p.kill()
            _, err = p.communicate(timeout=30)
    ref_log, port_log = (_read_log(p) for p in logs)
    assert len(ref_log) == len(port_log) == 9, err.decode()[-2000:]

    def changes(log):
        return sorted(json.dumps(u) for u in log)

    assert changes(port_log) == changes(ref_log)
    live: dict = {}
    for key, row, diff in port_log:
        live[key] = live.get(key, 0) + diff
    assert sum(v for v in live.values() if v) == 1  # only the added file's row is left


# -- writers --------------------------------------------------------------------


def _write_program(p, out_dir, suffix: str) -> None:
    t = p.debug.table_from_markdown(
        """
        word | count
        a    | 1
        b    | 2
        """
    )
    p.io.csv.write(t, str(out_dir / f"out{suffix}.csv"))
    p.io.jsonlines.write(t, str(out_dir / f"out{suffix}.jsonl"))
    p.io.null.write(t)


def test_writers_write_the_reference_lines(tmp_path):
    REF_G.clear()
    _write_program(ref_pw, tmp_path, "_ref")
    ref_pw.run()
    REF_G.clear()
    G.clear()
    _write_program(pw, tmp_path, "_port")
    pw.run(device="cpu")
    G.clear()
    for ext in ("csv", "jsonl"):
        want = (tmp_path / f"out_ref.{ext}").read_text().splitlines()
        got = (tmp_path / f"out_port.{ext}").read_text().splitlines()
        assert sorted(got) == sorted(want) and len(got) >= 2


# -- the engine without native tables ----------------------------------------


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_update_streams_equal_the_reference_without_native(name, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    want, got = _both(PROGRAMS[name])
    assert got == want
