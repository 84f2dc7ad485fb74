"""Python connector: user-scripted streaming sources (port of ``pathway_tpu/io/python/__init__.py``).

Subclass :class:`ConnectorSubject`, implement ``run`` and call ``next`` to
emit rows; ``read`` turns the subject into a streaming table. A schema's
primary key keys the rows, so pushing a row again under the same key
replaces it and ``_remove`` retracts it.
"""

from __future__ import annotations

from typing import Any, Dict

from pathway_tpu_torch.engine.datasource import PrimaryKey, StreamingDataSource
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


class ConnectorSubject:
    """Subclass and implement ``run``; call ``self.next(**values)`` to emit rows."""

    _source: StreamingDataSource | None = None
    _schema: sch.SchemaMetaclass | None = None

    def run(self) -> None:  # pragma: no cover
        raise NotImplementedError

    # -- emit API -----------------------------------------------------------

    def next(self, **kwargs: Any) -> None:
        self._emit(kwargs)

    def next_json(self, message: dict) -> None:
        self._emit(dict(message))

    def next_str(self, message: str) -> None:
        self._emit({"data": message})

    def next_bytes(self, message: bytes) -> None:
        self._emit({"data": message})

    def _emit(self, values: Dict[str, Any], diff: int = 1) -> None:
        key = None
        pk = self._schema.primary_key_columns() if self._schema else None
        if pk:
            key = PrimaryKey(values[c] for c in pk)
        assert self._source is not None, "subject not attached to a running graph"
        self._source.push(values, key=key, diff=diff)

    def _remove(self, values: Dict[str, Any]) -> None:
        self._emit(values, diff=-1)

    def commit(self) -> None:
        """End the batch: the rows emitted since the last commit enter the
        engine together (with ``autocommit_duration_ms=None``, only then)."""
        assert self._source is not None
        self._source.commit()

    def close(self) -> None:
        assert self._source is not None
        self._source.close()

    def on_stop(self) -> None:
        pass


class _SubjectRunner:
    def __init__(self, subject: ConnectorSubject):
        self.subject = subject

    def run(self, source: StreamingDataSource) -> None:
        self.subject._source = source
        try:
            self.subject.run()
        finally:
            self.subject.on_stop()


def read(
    subject: ConnectorSubject,
    *,
    schema: sch.SchemaMetaclass,
    autocommit_duration_ms: int | None = 100,
    name: str | None = None,
) -> Table:
    """A streaming table fed by ``subject`` on its own thread. Commits happen
    every ``autocommit_duration_ms``; with None, only at ``subject.commit()``."""
    source = StreamingDataSource(
        subject=_SubjectRunner(subject), autocommit_ms=autocommit_duration_ms
    )
    subject._schema = schema
    node = G.add_node(pg.InputNode(source=source, streaming=True, name=name or "python"))
    return Table(node, schema, name=name or "python")
