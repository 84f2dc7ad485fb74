"""Interactive (notebook) mode (port of ``pathway_tpu/internals/interactive.py``).

``enable_interactive_mode()`` sets ``Table.live()``, which runs the graph on
a background thread and returns a :class:`LiveTable`: a snapshot of the
table that its subscription keeps up to date. The run takes the port's
``device`` argument: the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_interactive_enabled = False


def is_interactive_mode_enabled() -> bool:
    return _interactive_enabled


def enable_interactive_mode() -> None:
    """Switch the session into interactive mode: ``Table.live()`` becomes
    available and runs the dataflow on a background thread."""
    global _interactive_enabled
    _interactive_enabled = True
    from pathway_tpu_torch.internals.table import Table

    if not hasattr(Table, "live"):
        Table.live = _table_live  # type: ignore[attr-defined]


class LiveTable:
    """A self-updating snapshot of a table."""

    def __init__(self, table: Any, *, device: Any = None):
        self._table = table
        self._rows: Dict[Any, dict] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None
        self._start(device)

    def _start(self, device: Any) -> None:
        from pathway_tpu_torch.engine.runner import GraphRunner
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.io._subscribe import subscribe

        def on_change(key: Any, row: dict, time: int, is_addition: bool) -> None:
            with self._lock:
                if is_addition:
                    self._rows[key] = row
                else:
                    self._rows.pop(key, None)

        subscribe(self._table, on_change)
        graph = G._current

        def run() -> None:
            try:
                GraphRunner(graph).run(device=device)
            except BaseException as exc:  # surfaced through .failed
                self._failed = exc

        self._thread = threading.Thread(target=run, daemon=True, name="pathway:live-table")
        self._thread.start()

    @property
    def failed(self) -> bool:
        return self._failed is not None

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(row) for row in self._rows.values()]

    def to_pandas(self) -> Any:
        from pathway_tpu_torch.internals.schema import import_pandas

        return import_pandas("LiveTable.to_pandas").DataFrame(self.snapshot())

    def __str__(self) -> str:
        rows = self.snapshot()
        if not rows:
            return "<LiveTable: empty>"
        names = list(rows[0])
        header = " | ".join(names)
        body = "\n".join(" | ".join(str(r[n]) for n in names) for r in rows)
        return f"{header}\n{body}"

    def _repr_pretty_(self, p: Any, cycle: bool) -> None:
        p.text(str(self))


def _table_live(self: Any, *, device: Any = None) -> LiveTable:
    if not _interactive_enabled:
        raise RuntimeError("call pw.enable_interactive_mode() first")
    return LiveTable(self, device=device)
