"""Cross-graph table handoff (port of ``pathway_tpu/io/export_import.py``).

``export_table`` attaches a live handle to a table of one dataflow graph;
``import_table`` mounts that handle as a streaming source of ANOTHER graph —
the importing graph first receives the exported table's current snapshot, then
every subsequent update, with original row keys preserved. The exporting and
importing graphs typically run on different threads (one long-running
background graph feeding short-lived foreground graphs). An exporting graph's
failure reaches its importers through ``OutputEvaluator.notify_failure``, and
an importer stops at ``GraphRunner.finish`` through ``_ImportSubject.stop``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.parse_graph import G


class ExportedTable:
    """Live handle over an exported table: frontier + snapshot + subscriptions
    (reference ``ExportedTable``: ``frontier()``, ``snapshot_at()``, callbacks)."""

    def __init__(self, column_names: List[str], schema: Any):
        self.column_names = list(column_names)
        self.schema = schema
        # reentrant: listeners run under this lock and may call back into the
        # public API (frontier/failed/subscribe, and snapshot_at of an
        # already-reached frontier). A snapshot_at that would have to WAIT from
        # inside a listener raises instead (the listener runs on the only
        # producing thread — waiting there could never be satisfied).
        self._lock = threading.RLock()
        self._advanced = threading.Condition(self._lock)
        self._dispatching: int | None = None  # thread id during listener dispatch
        self._rows: Dict[bytes, tuple] = {}  # kb -> (Pointer, row dict)
        self._frontier = -1
        self._closed = False
        self._failed: Optional[BaseException] = None
        self._listeners: List[Callable] = []

    # -- exporting-graph side ------------------------------------------------

    def _on_batch(self, keys: Any, diffs: Any, columns: Dict[str, Any], time: int) -> None:
        from pathway_tpu_torch.internals.keys import key_bytes, keys_to_pointers

        ptrs = keys_to_pointers(keys)
        kbs = key_bytes(keys)
        rows = [
            {c: columns[c][i] for c in self.column_names} for i in range(len(ptrs))
        ]
        dlist = [int(d) for d in diffs]
        # listeners are invoked UNDER the export lock: a concurrent subscribe()
        # then cannot observe a batch before (or interleaved with) its snapshot
        # delivery, and listeners never see two batches concurrently. Iterating
        # a COPY keeps a listener subscribed from inside this dispatch (it got
        # a snapshot that already includes this batch) from hearing the batch
        # a second time.
        with self._advanced:
            for kb, ptr, row, d in zip(kbs, ptrs, rows, dlist):
                if d > 0:
                    self._rows[kb] = (ptr, row)
                else:
                    self._rows.pop(kb, None)
            self._frontier = time
            self._advanced.notify_all()
            self._dispatching = threading.get_ident()
            try:
                for listener in list(self._listeners):
                    listener(list(zip(ptrs, rows, dlist)), time)
            finally:
                self._dispatching = None

    def _close(self) -> None:
        with self._advanced:
            if self._closed:
                return
            self._closed = True
            self._advanced.notify_all()
            self._dispatching = threading.get_ident()
            try:
                for listener in list(self._listeners):
                    listener(None, self._frontier)  # None batch = stream end
            finally:
                self._dispatching = None

    def _fail(self, exc: BaseException) -> None:
        with self._advanced:
            self._failed = exc
        self._close()

    # -- importing-graph / user side -----------------------------------------

    def frontier(self) -> int:
        with self._lock:
            return self._frontier

    def failed(self) -> bool:
        with self._lock:
            return self._failed is not None

    def snapshot_at(self, frontier: int | None = None, timeout: float | None = None) -> list:
        """(Pointer, row) pairs once the export has advanced to ``frontier``
        (reference ``snapshot_at``); None waits for whatever is current.
        Raises when the exporting graph failed, or closed before reaching the
        requested frontier — a crashed export must not read as a small table."""
        with self._advanced:
            if frontier is not None:
                need_wait = self._frontier < frontier and not self._closed
                if need_wait and self._dispatching == threading.get_ident():
                    raise RuntimeError(
                        "snapshot_at of a future frontier called from inside an "
                        "ExportedTable listener would deadlock the exporting "
                        "thread; listeners may only snapshot frontiers already "
                        "reached"
                    )
                ok = self._advanced.wait_for(
                    lambda: self._frontier >= frontier or self._closed,
                    timeout=timeout,
                )
                if not ok:
                    raise TimeoutError(
                        f"exported table did not reach frontier {frontier}"
                    )
            if self._failed is not None:
                raise RuntimeError("exporting graph failed") from self._failed
            if frontier is not None and self._frontier < frontier:
                raise RuntimeError(
                    f"export closed at frontier {self._frontier} before "
                    f"reaching {frontier}"
                )
            return [(ptr, dict(row)) for ptr, row in self._rows.values()]

    def subscribe(self, listener: Callable) -> None:
        """Register ``listener(events, time)`` — called with the CURRENT snapshot
        first (as inserts), then with every subsequent update batch; a ``None``
        events value signals stream end. Snapshot delivery, registration, and
        every later batch delivery all happen under the export lock, so the
        listener can never see a batch before (or interleaved with) its
        snapshot."""
        with self._advanced:
            snapshot = [
                (ptr, dict(row), 1) for ptr, row in self._rows.values()
            ]
            if snapshot:
                listener(snapshot, self._frontier)
            if self._closed:
                listener(None, self._frontier)
            else:
                self._listeners.append(listener)

    def unsubscribe(self, listener: Callable) -> None:
        with self._advanced:
            try:
                self._listeners.remove(listener)
            except ValueError:
                pass


def export_table(table: Any) -> ExportedTable:
    """Attach a live export handle to ``table`` (reference ``Graph::export_table``)."""
    exported = ExportedTable(table.column_names(), table._schema)
    G.add_node(
        pg.OutputNode(
            inputs=[table],
            batch_callback=exported._on_batch,
            on_end=exported._close,
            on_error=exported._fail,
        )
    )
    return exported


class _ImportSubject:
    """Streams an ExportedTable into a fresh graph, original keys preserved."""

    def __init__(self, exported: ExportedTable):
        self.exported = exported
        self._done = threading.Event()
        self._listener: Any = None

    def run(self, source: Any) -> None:
        def listener(events: Any, time: int) -> None:
            if events is None:
                self._done.set()
                return
            if self._done.is_set():
                return  # stopped importer: drop late batches instead of pushing
            for ptr, row, diff in events:
                source.push(dict(row), key=ptr, diff=diff)

        self._listener = listener
        self.exported.subscribe(listener)
        self._done.wait()
        if self.exported.failed():
            raise RuntimeError("exporting graph failed") from self.exported._failed

    def stop(self) -> None:
        """Graceful-shutdown hook (``GraphRunner.finish``): without it the import
        thread parks forever on ``_done.wait()`` whenever the exporting graph
        never closes."""
        self._done.set()
        if self._listener is not None:
            self.exported.unsubscribe(self._listener)


def import_table(exported: ExportedTable, *, autocommit_duration_ms: int | None = 50) -> Any:
    """Mount an :class:`ExportedTable` as a source of the CURRENT graph
    (reference ``Scope::import_table``, ``operator_handler.py:155``)."""
    from pathway_tpu_torch.engine.datasource import StreamingDataSource
    from pathway_tpu_torch.internals.table import Table

    source = StreamingDataSource(
        subject=_ImportSubject(exported), autocommit_ms=autocommit_duration_ms
    )
    node = G.add_node(pg.InputNode(source=source, streaming=True, name="import"))
    return Table(node, exported.schema, name="import")
