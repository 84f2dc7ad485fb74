"""Filesystem connector (port of ``pathway_tpu/io/fs.py``).

Static and streaming reads over csv / json(lines) / plaintext / binary files,
with the ``_metadata`` column, and ``write`` as csv or json lines. A CSV file
parses natively in one call (``native.parse_dsv_rows``: split, typed coercion
and row dicts), with ``csv.DictReader`` when the native module is unavailable,
the file has no schema or the delimiter is not one byte; a malformed typed
field is the ``ERROR`` cell either way.

Streaming mode polls the path: a new or changed file retracts the rows it
emitted before and emits its rows, a deleted file retracts its rows. A row's
key is derived from (file path, row index, "fs"), so a retraction re-derives
the key of the row it retracts. Each file's events end a commit, so a file
enters the engine whole.

Under persistence the scanner's state is journaled in-band: each file's
events are bracketed by ``push_begin(file, (mtime, size))`` and a slim
``push_state`` marker ``{"file", "mtime", "n_rows"}`` (the frame holds the
rows). On resume the markers fold back into the scan state, so an unchanged
file is replayed from the journal and not read again; a file modified or
deleted while the pipeline was down is retracted and read again. Not ported
yet: the hooks for elastic membership.
"""

from __future__ import annotations

import csv as _csv
import glob
import io as _io
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List

from pathway_tpu_torch import native
from pathway_tpu_torch.engine.columnar import ERROR
from pathway_tpu_torch.engine.datasource import PrimaryKey, StreamingDataSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import keys_from_rows, pointer_from
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def _coerce(value: str, dtype: dt.DType) -> Any:
    """A raw CSV field parsed per its schema dtype; a malformed field is the
    ``ERROR`` cell, so bad input stays apart from a genuine null."""
    base = dtype.strip_optional()
    if value is None:
        return None
    try:
        if base == dt.INT:
            return int(value)
        if base == dt.FLOAT:
            return float(value)
        if base == dt.BOOL:
            if value in ("true", "True", "1"):
                return True
            if value in ("false", "False", "0"):
                return False
            return ERROR
        if base == dt.JSON:
            return Json.parse(value)
    except (ValueError, TypeError):
        return ERROR
    return value


_TAGS = {dt.INT: 1, dt.FLOAT: 2, dt.BOOL: 3}


def _parse_dsv_bytes_native(
    data: bytes, delimiter: str, dtypes: Dict[str, dt.DType], has_schema: bool
) -> List[dict] | None:
    """The fused native CSV parse; None when the Python parser must take it.
    Typed coercion happens inside the parser; JSON columns are parsed after,
    in Python."""
    # without a schema the wanted columns are the header itself, which only
    # the DictReader path computes
    if not has_schema or native.get_lib() is None or len(delimiter.encode()) != 1:
        return None
    selected = []
    json_cols = []
    for name, dtype in dtypes.items():
        base = dtype.strip_optional()
        selected.append((name, _TAGS.get(base, 0)))
        if base == dt.JSON:
            json_cols.append(name)
    rows = native.parse_dsv_rows(data, selected, delimiter, ERROR)
    if rows is None:
        return None
    for name in json_cols:
        for row in rows:
            v = row.get(name)
            if isinstance(v, str):
                try:
                    row[name] = Json.parse(v)
                except Exception:
                    row[name] = ERROR
    return rows


def _iter_files(path: str, object_pattern: str = "*") -> List[str]:
    p = Path(path)
    if p.is_dir():
        return sorted(str(f) for f in p.rglob(object_pattern) if f.is_file())
    return sorted(glob.glob(path)) or ([str(p)] if p.exists() else [])


def _metadata_for(filepath: str) -> Json:
    st = os.stat(filepath)
    return Json(
        {
            "path": str(Path(filepath).resolve()),
            "size": st.st_size,
            "seen_at": int(time.time()),
            "modified_at": int(st.st_mtime),
            "owner": str(st.st_uid),
        }
    )


def parse_bytes(
    data: bytes,
    format: str,
    schema: sch.SchemaMetaclass | None,
    csv_settings: Any = None,
) -> List[dict]:
    """Wire-format bytes -> row dicts."""
    rows: List[dict] = []
    if format == "plaintext_by_file":
        rows.append({"data": data.decode("utf-8", "replace")})
    elif format == "plaintext":
        for line in data.decode("utf-8", "replace").splitlines():
            rows.append({"data": line})
    elif format in ("binary", "raw"):
        rows.append({"data": data})
    elif format == "csv":
        delimiter = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
        dtypes = schema.dtypes() if schema else {}
        native_rows = _parse_dsv_bytes_native(data, delimiter, dtypes, bool(schema))
        if native_rows is not None:
            rows.extend(native_rows)
        else:
            reader = _csv.DictReader(
                _io.StringIO(data.decode("utf-8", "replace")), delimiter=delimiter
            )
            for rec in reader:
                rows.append(
                    {
                        k: _coerce(v, dtypes.get(k, dt.STR))
                        for k, v in rec.items()
                        if k in dtypes or not schema
                    }
                )
    elif format in ("json", "jsonlines"):
        dtypes = schema.dtypes() if schema else {}
        for line in data.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            row = {}
            for name, dtype in (dtypes or {k: dt.ANY for k in rec}).items():
                v = rec.get(name)
                if dtype.strip_optional() == dt.JSON and v is not None:
                    v = Json(v)
                row[name] = v
            rows.append(row)
    else:
        raise ValueError(f"unknown format {format!r}")
    return rows


def _parse_file(
    filepath: str,
    format: str,
    schema: sch.SchemaMetaclass | None,
    with_metadata: bool,
    csv_settings: Any = None,
) -> List[dict]:
    with open(filepath, "rb") as f:
        rows = parse_bytes(f.read(), format, schema, csv_settings)
    if with_metadata:
        meta = _metadata_for(filepath)
        for row in rows:
            row["_metadata"] = meta
    return rows


def _row_key(filepath: str, i: int) -> PrimaryKey:
    # hashed with the rest of the commit's keys when the source drains
    return PrimaryKey((filepath, i, "fs"))


class _FsSubject:
    def __init__(
        self,
        path: str,
        format: str,
        schema: sch.SchemaMetaclass | None,
        mode: str,
        with_metadata: bool,
        object_pattern: str,
        refresh_interval: float = 0.5,
        csv_settings: Any = None,
    ):
        self.path = path
        self.format = format
        self.schema = schema
        self.mode = mode
        self.with_metadata = with_metadata
        self.object_pattern = object_pattern
        self.refresh_interval = refresh_interval
        self.csv_settings = csv_settings
        self.seen: Dict[str, float] = {}
        self.emitted: Dict[str, List[dict]] = {}
        # (file, mtime) -> the rows pushed for that version (the lists of
        # ``emitted``, not copies): a checkpoint pairs a drained marker with
        # its own version's rows, although the scanner may be a version
        # ahead of the engine. The last two versions of a file are kept.
        self._pushed: Dict[tuple, List[dict]] = {}
        # rows read from disk by this run, per file (a file replayed from the
        # journal is not read)
        self.rows_read: Dict[str, int] = {}

    # -- persistence: the scan state (``seen`` / ``emitted``) is journaled as
    # one slim delta per file, after the file's events

    @staticmethod
    def fold_state_deltas(state_deltas: list) -> list:
        """A marker history folded to one delta per live file."""
        seen: Dict[str, dict] = {}
        for delta in state_deltas:
            if delta.get("deleted"):
                seen.pop(delta["file"], None)
            else:
                seen[delta["file"]] = delta
        return [seen[f] for f in sorted(seen)]

    def restore(self, state_deltas: list) -> None:
        """Fold journaled per-file deltas back into the scan state (before
        the scanner thread starts). They arrive with their rows: a
        checkpoint's carry them, a journal frame's are rehydrated by the
        runner from the frames' input deltas."""
        for delta in state_deltas:
            filepath = delta["file"]
            if delta.get("deleted"):
                self.seen.pop(filepath, None)
                self.emitted.pop(filepath, None)
                continue
            if "rows" not in delta:
                raise ValueError(
                    f"fs scan-state delta for {filepath!r} reached restore "
                    "without rows: the journal frame that carried it lost "
                    "its input deltas (corrupt journal) — clear the "
                    "persistence directory to start fresh"
                )
            self.seen[filepath] = delta["mtime"]
            self.emitted[filepath] = list(delta["rows"])
            self._pushed[(filepath, delta["mtime"])] = self.emitted[filepath]

    def hydrate_state_deltas(self, state_deltas: list) -> list:
        """The markers with their rows, for a checkpoint (the frames up to it
        are compacted away). A marker takes its own version's rows, even when
        the scanner has read the file again since."""
        out = []
        for delta in state_deltas:
            if delta.get("deleted") or "rows" in delta:
                out.append(delta)
                continue
            rows = self._pushed.get((delta["file"], delta["mtime"]))
            if rows is None:
                rows = self.emitted.get(delta["file"], [])
            out.append({**delta, "rows": list(rows)})
        return out

    @staticmethod
    def rehydrate_state_deltas(state_deltas: list, row_values: dict) -> list:
        """The rows of journaled markers, from their frames' input deltas
        (``row_values``: row-key bytes -> values). Row keys are derived from
        (file, row index), so the lookup is exact."""
        out = []
        for delta in state_deltas:
            if delta.get("deleted") or "rows" in delta:
                out.append(delta)
                continue
            filepath = delta["file"]
            n = int(delta.get("n_rows", 0))
            keys = keys_from_rows([_row_key(filepath, i) for i in range(n)])
            rows = []
            for i in range(n):
                got = row_values.get(keys[i].tobytes())
                if got is None:
                    raise ValueError(
                        f"fs scan-state marker for {filepath!r} names {n} "
                        f"row(s) but row {i} is absent from the journal "
                        "frames (corrupt journal) — clear the persistence "
                        "directory to start fresh"
                    )
                rows.append(got)
            out.append({**delta, "rows": rows})
        return out

    def _process_file(self, source: StreamingDataSource, filepath: str) -> None:
        st = os.stat(filepath)
        # read before pushing anything: a concurrent deletion then raises while
        # the event stream is still untouched
        rows = _parse_file(
            filepath, self.format, self.schema, self.with_metadata, self.csv_settings
        )
        self.rows_read[filepath] = self.rows_read.get(filepath, 0) + len(rows)
        source.push_begin(filepath, (st.st_mtime, st.st_size))
        for i, row in enumerate(self.emitted.get(filepath, ())):
            source.push(row, key=_row_key(filepath, i), diff=-1)
        for i, row in enumerate(rows):
            source.push(row, key=_row_key(filepath, i), diff=1)
        self.seen[filepath] = st.st_mtime
        self.emitted[filepath] = rows
        stale = [k for k in self._pushed if k[0] == filepath and k[1] != st.st_mtime][:-1]
        for k in stale:
            self._pushed.pop(k, None)
        self._pushed[(filepath, st.st_mtime)] = rows
        # the marker ends the file's commit
        source.push_state({"file": filepath, "mtime": st.st_mtime, "n_rows": len(rows)})

    def _process_deletion(self, source: StreamingDataSource, filepath: str) -> None:
        source.push_begin(filepath, ("deleted",))
        for i, row in enumerate(self.emitted.get(filepath, ())):
            source.push(row, key=_row_key(filepath, i), diff=-1)
        self.seen.pop(filepath, None)
        self.emitted.pop(filepath, None)
        for k in [k for k in self._pushed if k[0] == filepath]:
            self._pushed.pop(k, None)
        source.push_state({"file": filepath, "deleted": True})

    def run(self, source: StreamingDataSource) -> None:
        from pathway_tpu_torch.internals.config import get_pathway_config

        while True:
            cfg = get_pathway_config()
            present = _iter_files(self.path, self.object_pattern)
            if cfg.processes > 1:
                # each process of a cluster reads the files of its hash shard
                present = [
                    f for f in present if pointer_from(f).lo % cfg.processes == cfg.process_id
                ]
            for filepath in present:
                try:
                    if self.seen.get(filepath) == os.stat(filepath).st_mtime:
                        continue
                    self._process_file(source, filepath)
                except FileNotFoundError:
                    continue  # deleted between listing and read: the next pass retracts it
            for gone in sorted(set(self.seen) - set(present)):
                self._process_deletion(source, gone)
            # one full pass: a file the crash cut and this pass lacks is gone
            source.push_barrier()
            if self.mode in ("static", "batch"):
                return
            time.sleep(self.refresh_interval)


def read(
    path: str | Path,
    *,
    format: str = "plaintext",
    schema: sch.SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    json_field_paths: dict | None = None,
    object_pattern: str = "*",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 100,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """A table of the rows of the files under ``path``. ``mode="static"``
    reads them once; ``"streaming"`` (the default) polls every half second
    for new, changed and deleted files."""
    path = str(path)
    if schema is None:
        if format in ("plaintext", "plaintext_by_file"):
            schema = sch.schema_from_types(data=str)
        elif format == "binary":
            schema = sch.schema_from_types(data=bytes)
        else:
            raise ValueError(f"schema is required for format {format!r}")
    out_schema = schema
    if with_metadata:
        out_schema = sch.schema_from_columns(
            {**schema.columns(), "_metadata": sch.ColumnSchema("_metadata", dt.JSON)},
            name="fs",
        )
    subject = _FsSubject(
        path, format, schema, mode, with_metadata, object_pattern, csv_settings=csv_settings
    )
    source = StreamingDataSource(subject=subject, autocommit_ms=autocommit_duration_ms)
    node = G.add_node(pg.InputNode(source=source, streaming=mode == "streaming", name=name or "fs"))
    return Table(node, out_schema, name=name or "fs")


class _FileWriter:
    def __init__(self, filename: str, format: str):
        self.filename = filename
        self.format = format
        self.file = open(filename, "w")
        self.lock = threading.Lock()

    def write_row(self, row: dict, time_: int, diff: int) -> None:
        with self.lock:
            if self.format == "json":
                rec = {**_plain(row), "time": time_, "diff": diff}
                self.file.write(json.dumps(rec) + "\n")
            else:
                values = [str(v) for v in _plain(row).values()] + [str(time_), str(diff)]
                self.file.write(",".join(values) + "\n")
            self.file.flush()

    def close(self) -> None:
        self.file.close()


def _plain(row: dict) -> dict:
    out = {}
    for k, v in row.items():
        if isinstance(v, Json):
            out[k] = v.value
        elif hasattr(v, "as_int") and type(v).__name__ == "Pointer":
            out[k] = repr(v)
        elif isinstance(v, bytes):
            out[k] = v.decode(errors="replace")
        else:
            out[k] = v
    return out


def write(
    table: Table, filename: str | Path, *, format: str = "json", name: str | None = None,
    **kwargs: Any,
) -> None:
    """Write the table's update stream: one line per change, with its
    ``time`` and ``diff`` (+1 / -1)."""
    writer = _FileWriter(str(filename), format)

    def callback(key: Any, row: dict, time: int, is_addition: bool) -> None:
        writer.write_row(row, time, 1 if is_addition else -1)

    G.add_node(pg.OutputNode(inputs=[table], callback=callback, on_end=writer.close))
