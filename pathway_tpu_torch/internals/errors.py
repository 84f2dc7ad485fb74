"""Error-log tables: ``pw.global_error_log`` / ``pw.local_error_log`` (port
of ``pathway_tpu/internals/errors.py``).

With ``pw.run(terminate_on_error=False)`` a raising UDF poisons its cell with
``Error`` and appends a row (operator_id, message, trace) to an error-log
table instead of failing the run: the log of the ``local_error_log`` context
the operator was built in, else the graph's global log.
"""

from __future__ import annotations

import contextlib
from typing import Any, Generator, List

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta
from pathway_tpu_torch.engine.datasource import DataSource
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import sequential_keys
from pathway_tpu_torch.internals.parse_graph import G


class ErrorLogSource(DataSource):
    """Collects the engine thread's errors. It drains in its place in the
    node order: errors of the operators before it in the same commit, of the
    others in the next."""

    drains_in_place = True

    def __init__(self) -> None:
        self.pending: List[tuple] = []
        self._seq = 0

    def push(self, operator_id: int, message: str, trace: Any = None) -> None:
        self.pending.append((operator_id, message, trace))

    def next_batch(self, column_names: List[str]) -> Delta:
        if not self.pending:
            return Delta.empty(column_names)
        rows, self.pending = self.pending, []
        n = len(rows)
        keys = sequential_keys(self._seq, n)
        self._seq += n
        columns = {}
        for j, name in enumerate(["operator_id", "message", "trace"]):
            col = np.empty(n, dtype=object)
            for i, row in enumerate(rows):
                col[i] = row[j]
            columns[name] = col
        return Delta(keys, np.ones(n, dtype=np.int64), columns)

    def is_finished(self) -> bool:
        return not self.pending


def _error_log_schema() -> sch.SchemaMetaclass:
    from pathway_tpu_torch.internals import dtype as dt

    return sch.schema_from_columns(
        {
            "operator_id": sch.ColumnSchema("operator_id", dt.INT),
            "message": sch.ColumnSchema("message", dt.STR),
            "trace": sch.ColumnSchema("trace", dt.ANY),
        },
        "ErrorLog",
    )


def global_error_log() -> Any:
    """The graph's error-log table (made on first call, one per graph)."""
    from pathway_tpu_torch.internals.table import Table

    graph = G._current
    existing = getattr(graph, "_global_error_log", None)
    if existing is not None:
        return existing
    source = ErrorLogSource()
    node = G.add_node(pg.InputNode(source=source, name="error_log"))
    table = Table(node, _error_log_schema(), name="error_log")
    graph._global_error_log = table
    graph._error_log_source = source
    graph.error_logs.append(table)
    return table


@contextlib.contextmanager
def local_error_log() -> Generator[Any, None, None]:
    """Scoped error log: operators built while the context is open report
    their errors to this table."""
    from pathway_tpu_torch.internals.table import Table

    source = ErrorLogSource()
    node = G.add_node(pg.InputNode(source=source, name="local_error_log"))
    table = Table(node, _error_log_schema(), name="local_error_log")
    graph = G._current
    stack = getattr(graph, "_error_log_stack", None)
    if stack is None:
        stack = graph._error_log_stack = []
    stack.append(source)
    try:
        yield table
    finally:
        stack.pop()
