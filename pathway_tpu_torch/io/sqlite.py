"""SQLite connector (port of ``pathway_tpu/io/sqlite.py``): the whole table is
read by ``rowid`` every ``poll_interval`` seconds; a new row is ``+1``, a changed
row ``-1`` then ``+1``, and a vanished row ``-1``. ``mode="static"`` reads once.
Only the stdlib ``sqlite3`` is used.

The rows take the keys the source would give them (sequential, one per
event, as in the reference), but a retraction carries the key its row was
inserted under. The reference pushes a retraction without a key, so it gets
a fresh sequential key that no row holds, and a table kept downstream (the
data table of an index, a table read by ``ix``) fails with ``retraction of
absent key`` at the first update or delete."""

from __future__ import annotations

import sqlite3
import time
from typing import Any

from pathway_tpu_torch.engine.datasource import StreamingDataSource
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import keys_to_pointers, sequential_keys
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


class _SqliteSubject:
    def __init__(self, path: str, table_name: str, schema: sch.SchemaMetaclass, mode: str, poll_interval: float = 0.5):
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.mode = mode
        self.poll_interval = poll_interval

    def run(self, source: StreamingDataSource) -> None:
        last_rows: dict = {}
        keys: dict = {}  # rowid -> the key its row was inserted under
        seq = 0
        names = self.schema.column_names()

        def next_key():
            # the key an unkeyed push would take: every event takes one
            nonlocal seq
            seq += 1
            return keys_to_pointers(sequential_keys(seq - 1, 1))[0]

        while True:
            conn = sqlite3.connect(self.path)
            try:
                cur = conn.execute(
                    f"SELECT rowid, {', '.join(names)} FROM {self.table_name}"
                )
                current = {}
                for rec in cur.fetchall():
                    rowid, values = rec[0], dict(zip(names, rec[1:]))
                    current[rowid] = values
            finally:
                conn.close()
            for rowid, values in current.items():
                if rowid not in last_rows:
                    keys[rowid] = next_key()
                    source.push(values, key=keys[rowid], diff=1)
                elif last_rows[rowid] != values:
                    next_key()
                    source.push(last_rows[rowid], key=keys[rowid], diff=-1)
                    keys[rowid] = next_key()
                    source.push(values, key=keys[rowid], diff=1)
            for rowid, values in last_rows.items():
                if rowid not in current:
                    next_key()
                    source.push(values, key=keys.pop(rowid), diff=-1)
            last_rows = current
            if self.mode != "streaming":
                return
            time.sleep(self.poll_interval)


def read(
    path: str,
    table_name: str,
    schema: sch.SchemaMetaclass,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 100,
    **kwargs: Any,
) -> Table:
    subject = _SqliteSubject(path, table_name, schema, mode)

    class _Runner:
        def run(self, source: StreamingDataSource) -> None:
            subject.run(source)

    source = StreamingDataSource(subject=_Runner(), autocommit_ms=autocommit_duration_ms)
    node = G.add_node(pg.InputNode(source=source, streaming=mode == "streaming", name="sqlite"))
    return Table(node, schema, name="sqlite")
