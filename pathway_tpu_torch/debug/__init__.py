"""Debug & testing API (port of ``pathway_tpu/debug/__init__.py``).

``table_from_markdown`` / ``table_from_rows`` build static or timed
(``__time__`` / ``__diff__``) input tables; ``compute_and_print`` and the
capture helpers run the graph and read a table's rows or update stream.
``device`` is where the run offloads device work (the card unless
``"cpu"``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta
from pathway_tpu_torch.engine.datasource import StaticDataSource
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import Pointer, pointer_from, sequential_keys
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

_SPECIAL_COLUMNS = {"__time__", "__diff__"}


def _parse_value(token: str) -> Any:
    token = token.strip()
    if token in ("", "None"):
        return None
    if token == "True":
        return True
    if token == "False":
        return False
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token


def table_from_markdown(
    table_def: str,
    *,
    id_from: list[str] | None = None,
    schema: Any = None,
    unsafe_trusted_ids: bool = False,
    split_on_whitespace_only: bool = False,
) -> Table:
    """Build a static table from a markdown-ish definition.

    Supports an optional unnamed leading id column and ``__time__``/``__diff__`` columns for
    simulating update streams.
    """
    lines = [l for l in table_def.strip().splitlines() if l.strip() and not set(l.strip()) <= {"-", "|", " "}]
    if not lines:
        raise ValueError("empty table definition")
    if split_on_whitespace_only:
        header = re.split(r"\s+", lines[0].strip())
        rows_raw = [re.split(r"\s+", l.strip()) for l in lines[1:]]
    else:
        header = [h.strip() for h in lines[0].split("|")]
        rows_raw = [[c for c in l.split("|")] for l in lines[1:]]

    has_id_col = header[0] == ""
    if has_id_col:
        header = header[1:]
    names = [h for h in header]

    rows: List[dict] = []
    keys: List[Pointer] = []
    times: List[int] = []
    diffs: List[int] = []
    for cells in rows_raw:
        cells = [c.strip() for c in cells]
        if has_id_col:
            row_id, cells = cells[0], cells[1:]
            keys.append(pointer_from(row_id, "mkdtable"))
        if len(cells) != len(names):
            raise ValueError(f"row {cells!r} does not match header {names!r}")
        row = {}
        t, d = 0, 1
        for name, cell in zip(names, cells):
            value = _parse_value(cell)
            if name == "__time__":
                t = int(value)
            elif name == "__diff__":
                d = int(value)
            else:
                row[name] = value
        rows.append(row)
        times.append(t)
        diffs.append(d)

    data_names = [n for n in names if n not in _SPECIAL_COLUMNS]
    if schema is not None:
        schema_cls = schema
        for row in rows:
            for name, col in schema_cls.columns().items():
                if name in row and row[name] is not None:
                    row[name] = _coerce_to(row[name], col.dtype)
        pk = schema_cls.primary_key_columns()
        if pk:
            keys = [pointer_from(*(row[c] for c in pk)) for row in rows]
    else:
        schema_cls = _infer_schema(rows, data_names)
        if id_from:
            keys = [pointer_from(*(row[c] for c in id_from)) for row in rows]

    streaming = any(n in _SPECIAL_COLUMNS for n in names)
    if streaming:
        source: Any = _TimedSource(rows, keys if keys else None, times, diffs)
    else:
        key_arr = None
        if keys:
            from pathway_tpu_torch.internals.keys import pointers_to_keys

            key_arr = pointers_to_keys(keys)
        source = StaticDataSource(rows, keys=key_arr)
    node = G.add_node(pg.InputNode(source=source, streaming=False))
    return Table(node, schema_cls, name="markdown")


def _coerce_to(value: Any, dtype: dt.DType) -> Any:
    base = dtype.strip_optional()
    try:
        if base == dt.INT:
            return int(value)
        if base == dt.FLOAT:
            return float(value)
        if base == dt.STR:
            return str(value)
        if base == dt.BOOL:
            if isinstance(value, bool):
                return value
            return value == "True"
    except (TypeError, ValueError):
        pass
    return value


def _infer_schema(rows: List[dict], names: List[str]) -> sch.SchemaMetaclass:
    columns: Dict[str, sch.ColumnSchema] = {}
    for name in names:
        values = [row.get(name) for row in rows]
        non_null = [v for v in values if v is not None]
        if not non_null:
            dtype: dt.DType = dt.NONE
        elif all(isinstance(v, bool) for v in non_null):
            dtype = dt.BOOL
        elif all(isinstance(v, int) and not isinstance(v, bool) for v in non_null):
            dtype = dt.INT
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in non_null):
            dtype = dt.FLOAT
        elif all(isinstance(v, str) for v in non_null):
            dtype = dt.STR
        else:
            dtype = dt.ANY
        if any(v is None for v in values) and dtype not in (dt.NONE, dt.ANY):
            dtype = dt.Optional_(dtype)
        columns[name] = sch.ColumnSchema(name, dtype)
    return sch.schema_from_columns(columns, "markdown")


class _TimedSource(StaticDataSource):
    """Rows released per __time__ value, with __diff__ signs — update-stream simulation."""

    def __init__(
        self,
        rows: List[dict],
        keys: List[Pointer] | None,
        times: List[int],
        diffs: List[int],
        columns: Dict[str, np.ndarray] | None = None,
    ):
        super().__init__(rows)
        self._times = times
        self._diffs = np.asarray(diffs, dtype=np.int64)
        self._prebuilt_columns = columns  # built at graph construction, off the run clock
        self._pointers = keys
        self._schedule = sorted(set(times))
        self._pos = 0
        self._col_arrays: Dict[str, np.ndarray] | None = None
        # All timed sources of one graph share a global clock: each commit releases the
        # rows of the earliest pending __time__ across the whole graph, so interleaved
        # streams (e.g. events vs a wall-clock table) arrive in deterministic order.
        from pathway_tpu_torch.internals.parse_graph import G

        self._clock = G.timed_source_clock
        self._clock.register(self)

    def on_start(self) -> None:
        self._pos = 0
        self._done = False
        self._clock._polled = set()
        self._clock._round_min = None

    def _next_time(self) -> Any:
        if self._done or self._pos >= len(self._schedule):
            return None
        return self._schedule[self._pos]

    def _materialize(self, column_names: List[str]) -> None:
        """One-time columnar layout: whole-dataset column arrays, per-time row index
        slices, and (when keys are value-derived) one vectorized base-key hash."""
        from pathway_tpu_torch.engine.expression_evaluator import _tidy
        from pathway_tpu_torch.internals.keys import KEY_DTYPE, pointers_to_keys

        n = len(self._rows)
        prebuilt = getattr(self, "_prebuilt_columns", None)
        self._col_arrays = {}
        for name in column_names:
            if prebuilt is not None and name in prebuilt:
                self._col_arrays[name] = prebuilt[name]
                continue
            col = np.empty(n, dtype=object)
            for i, row in enumerate(self._rows):
                col[i] = row.get(name)
            self._col_arrays[name] = _tidy(col)
        times = np.asarray(self._times)
        self._time_rows = {}
        if n:
            order = np.argsort(times, kind="stable")
            sorted_t = times[order]
            bounds = np.nonzero(np.diff(sorted_t))[0] + 1
            for chunk in np.split(order, bounds):
                # chunk holds ORIGINAL row indices: look the time up in `times`,
                # not `sorted_t` (equal only when rows arrive pre-sorted by time)
                self._time_rows[times[chunk[0]].item()] = chunk
        if self._pointers:
            self._all_keys = pointers_to_keys(self._pointers)
        else:
            # value-derived row identity: one hash over all value columns
            # (sorted names, as the old per-row token did), then GLOBAL occurrence
            # numbers so duplicate rows get distinct deterministic keys. Occurrence
            # counters follow release order (time, then input order) and pair a
            # __diff__=-1 row LIFO with its matching insert.
            from pathway_tpu_torch.internals.keys import key_bytes, keys_from_values

            value_cols = [
                self._col_arrays[name] for name in sorted(self._col_arrays)
            ]
            base = (
                keys_from_values(value_cols)
                if value_cols
                else np.zeros(n, dtype=KEY_DTYPE)
            )
            release = np.concatenate(
                [self._time_rows[t] for t in sorted(self._time_rows)]
            ) if n else np.zeros(0, dtype=np.int64)
            diffs = np.asarray(self._diffs, dtype=np.int64)
            occ = np.zeros(n, dtype=np.int64)
            if (diffs >= 0).all():
                # pure-insert stream: occurrence = rank within duplicate group, in
                # release order — one vectorized pass over index slots
                from pathway_tpu_torch.engine.index import KeyIndex

                slots, _ = KeyIndex(n).upsert(base[release])
                grouped = np.argsort(slots, kind="stable")
                sorted_slots = slots[grouped]
                starts = np.nonzero(
                    np.diff(sorted_slots, prepend=sorted_slots[:1] - 1)
                )[0]
                rank = np.arange(len(slots), dtype=np.int64)
                first_of_group = np.zeros(len(slots), dtype=np.int64)
                first_of_group[starts] = starts
                first_of_group = np.maximum.accumulate(first_of_group)
                occ_in_release = np.empty(len(slots), dtype=np.int64)
                occ_in_release[grouped] = rank - first_of_group
                occ[release] = occ_in_release
            else:
                occurrences: dict = {}
                kbs = key_bytes(base)
                for i in release.tolist():
                    bb = kbs[i]
                    if diffs[i] > 0:
                        o = occurrences.get(bb, 0)
                        occurrences[bb] = o + 1
                    else:
                        o = occurrences.get(bb, 1) - 1
                        occurrences[bb] = o
                    occ[i] = o
            salt = np.empty(n, dtype=object)
            salt[:] = "timedrow"
            self._all_keys = (
                keys_from_values([base, occ, salt]) if n else np.zeros(0, dtype=KEY_DTYPE)
            )

    def next_batch(self, column_names: List[str]) -> Delta:
        if getattr(self, "_col_arrays", None) is None:
            self._materialize(column_names)
        if self._pos >= len(self._schedule):
            self._done = True
            return Delta.empty(column_names)
        if not self._clock.may_release(self):
            # another source owns the globally-earliest timestamp; wait our turn
            return Delta.empty(column_names)
        t = self._schedule[self._pos]
        self._pos += 1
        if self._pos >= len(self._schedule):
            self._done = True
        idx = self._time_rows[t]
        if len(idx) > 1 and idx[0] + len(idx) - 1 == idx[-1] and (np.diff(idx) == 1).all():
            # time-contiguous rows (the common layout: streams are built in
            # commit order): basic slicing returns zero-copy VIEWS instead of
            # one fancy-gather copy per column — deltas are immutable once
            # emitted, so sharing the backing arrays is safe
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            columns = {name: self._col_arrays[name][sl] for name in column_names}
            return Delta(self._all_keys[sl], self._diffs[sl], columns)
        columns = {name: self._col_arrays[name][idx] for name in column_names}
        return Delta(self._all_keys[idx], self._diffs[idx], columns)

    def is_finished(self) -> bool:
        return self._done


def table_from_rows(
    schema: sch.SchemaMetaclass,
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    names = schema.column_names()
    dict_rows = []
    for row in rows:
        if is_stream:
            *values, t, d = row
            r = dict(zip(names, values))
            r["__time__"], r["__diff__"] = t, d
        else:
            r = dict(zip(names, row))
        dict_rows.append(r)
    pk = schema.primary_key_columns()
    keys = [pointer_from(*(r[c] for c in pk)) for r in dict_rows] if pk else None
    if is_stream:
        from pathway_tpu_torch.engine.columnar import objarray
        from pathway_tpu_torch.engine.expression_evaluator import _tidy

        # columnarize once at graph-build time (one zip pass per column), so the
        # run-time source only slices
        value_cols = list(zip(*(r[:-2] for r in rows))) if rows else [()] * len(names)
        columns = {
            name: _tidy(objarray(list(vals))) for name, vals in zip(names, value_cols)
        }
        source: Any = _TimedSource(
            [{k: v for k, v in r.items() if k not in _SPECIAL_COLUMNS} for r in dict_rows],
            keys,
            [r["__time__"] for r in dict_rows],
            [r["__diff__"] for r in dict_rows],
            columns=columns,
        )
        # columnar layout + key derivation happen at graph build, off the run clock
        source._materialize(names)
    else:
        key_arr = None
        if keys:
            from pathway_tpu_torch.internals.keys import pointers_to_keys

            key_arr = pointers_to_keys(keys)
        from pathway_tpu_torch.engine.columnar import objarray
        from pathway_tpu_torch.engine.expression_evaluator import _tidy

        value_cols = list(zip(*rows)) if rows else [()] * len(names)
        columns = {
            name: _tidy(objarray(list(vals))) for name, vals in zip(names, value_cols)
        }
        source = StaticDataSource(dict_rows, keys=key_arr, columns=columns)
    node = G.add_node(pg.InputNode(source=source))
    return Table(node, schema, name="rows")


def table_from_pandas(
    df: Any,
    *,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any = None,
) -> Table:
    """A static table of a DataFrame's rows; keys come from ``id_from``, else
    from a non-default index, else from the row values."""
    sch.import_pandas("table_from_pandas")
    rows = []
    for _, prow in df.iterrows():
        row = {}
        for col in df.columns:
            v = prow[col]
            if isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.bool_):
                v = bool(v)
            row[str(col)] = v
        rows.append(row)
    schema_cls = schema if schema is not None else sch.schema_from_pandas(df, id_from=id_from)
    keys = None
    if id_from:
        from pathway_tpu_torch.internals.keys import pointers_to_keys

        keys = pointers_to_keys([pointer_from(*(r[c] for c in id_from)) for r in rows])
    elif df.index is not None and not df.index.equals(type(df.index)(range(len(df)))):
        from pathway_tpu_torch.internals.keys import pointers_to_keys

        keys = pointers_to_keys([pointer_from(i, "pandas") for i in df.index])
    source = StaticDataSource(rows, keys=keys)
    node = G.add_node(pg.InputNode(source=source))
    return Table(node, schema_cls, name="pandas")


def _capture_table(
    table: Table, *, terminate_on_error: bool = True, device: Any = None
) -> Dict[bytes, dict]:
    """Run the graph and return the table's final rows keyed by key bytes."""
    from pathway_tpu_torch.internals.keys import pointers_to_keys

    captured: Dict[bytes, dict] = {}

    def on_change(key: Pointer, row: dict, time: int, is_addition: bool) -> None:
        kb = pointers_to_keys([key]).tobytes()
        if is_addition:
            captured[kb] = {"__key__": key, **row}
        else:
            captured.pop(kb, None)

    G.add_node(pg.OutputNode(inputs=[table], callback=on_change))
    GraphRunner(G).run(terminate_on_error=terminate_on_error, device=device)
    return captured


def _capture_update_stream(
    table: Table, *, terminate_on_error: bool = True, device: Any = None
) -> List[dict]:
    updates: List[dict] = []

    def on_change(key: Pointer, row: dict, time: int, is_addition: bool) -> None:
        updates.append({"__key__": key, "__time__": time, "__diff__": 1 if is_addition else -1, **row})

    G.add_node(pg.OutputNode(inputs=[table], callback=on_change))
    GraphRunner(G).run(terminate_on_error=terminate_on_error, device=device)
    return updates


def table_to_pandas(table: Table, *, include_id: bool = True, device: Any = None) -> Any:
    """Run the graph and return the table's final rows as a DataFrame indexed by key."""
    pd = sch.import_pandas("table_to_pandas")
    captured = _capture_table(table, device=device)
    names = table.column_names()
    data = {name: [row[name] for row in captured.values()] for name in names}
    index = [row["__key__"] for row in captured.values()]
    return pd.DataFrame(data, index=index, columns=names)


def _print_rows(rows: List[dict], names: List[str], include_id: bool, short_pointers: bool) -> None:
    header = ([""] if include_id else []) + names
    print(" | ".join(header).strip())
    for row in rows:
        cells = []
        if include_id:
            key = row["__key__"]
            cells.append(f"^{key.as_int():X}"[:12] + "..." if short_pointers else repr(key))
        cells.extend(str(row[n]) for n in names)
        print(" | ".join(cells))


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    terminate_on_error: bool = True,
    device: Any = None,
) -> None:
    """Print the table's final rows, or with ``squash_updates=False`` its
    whole update stream (``compute_and_print_update_stream``)."""
    if not squash_updates:
        compute_and_print_update_stream(
            table,
            include_id=include_id,
            short_pointers=short_pointers,
            n_rows=n_rows,
            terminate_on_error=terminate_on_error,
            device=device,
        )
        return
    captured = _capture_table(table, terminate_on_error=terminate_on_error, device=device)
    rows = sorted(captured.values(), key=lambda r: r["__key__"])
    if n_rows is not None:
        rows = rows[:n_rows]
    _print_rows(rows, table.column_names(), include_id, short_pointers)


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    terminate_on_error: bool = True,
    device: Any = None,
) -> None:
    """Print every update of the table with its ``__time__`` and ``__diff__``."""
    updates = _capture_update_stream(table, terminate_on_error=terminate_on_error, device=device)
    if n_rows is not None:
        updates = updates[:n_rows]
    _print_rows(updates, table.column_names() + ["__time__", "__diff__"], include_id, short_pointers)


class StreamGenerator:
    """Scripted stream fixture: batch ``t`` of a list arrives at ``__time__`` ``t``."""

    def table_from_list_of_batches(
        self, batches: List[List[dict]], schema: sch.SchemaMetaclass
    ) -> Table:
        rows: List[dict] = []
        times: List[int] = []
        for t, batch in enumerate(batches):
            for row in batch:
                rows.append({k: v for k, v in row.items() if k not in _SPECIAL_COLUMNS})
                times.append(t)
        source = _TimedSource(rows, None, times, [1] * len(rows))
        node = G.add_node(pg.InputNode(source=source))
        return Table(node, schema, name="stream_generator")

    def table_from_list_of_batches_by_workers(
        self, batches: Dict[int, List[List[dict]]], schema: sch.SchemaMetaclass
    ) -> Table:
        """One process holds every worker: batch ``t`` of each worker merges
        into the one batch at time ``t``."""
        merged: List[List[dict]] = []
        for worker_batches in batches.values():
            for t, batch in enumerate(worker_batches):
                while len(merged) <= t:
                    merged.append([])
                merged[t].extend(batch)
        return self.table_from_list_of_batches(merged, schema)
