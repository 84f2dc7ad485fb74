"""Live visualization (port of ``pathway_tpu/stdlib/viz``).

``table_snapshot`` keeps a table's current rows and needs nothing else;
``plot`` and ``show`` draw them with bokeh and panel, imported when called
(the GPU machine has neither, nor pandas): without them they raise
``ImportError``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._subscribe import subscribe


def _require_bokeh() -> None:
    try:
        import bokeh  # noqa: F401
        import panel  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "bokeh/panel are not available in this environment; use "
            "pw.viz.table_snapshot(table) for the raw updating data"
        ) from exc


class _SnapshotCollector:
    """Subscribes to a table and keeps its current rows, thread-safely."""

    def __init__(self, table: Table):
        self.rows: Dict[Any, dict] = {}
        self.lock = threading.Lock()
        self.listeners: list[Callable[[list], None]] = []

        def on_change(key: Any, row: dict, time: int, is_addition: bool) -> None:
            with self.lock:
                if is_addition:
                    self.rows[key] = row
                else:
                    self.rows.pop(key, None)
                current = [dict(r) for r in self.rows.values()]
            for listener in self.listeners:
                listener(current)

        subscribe(table, on_change)

    def snapshot(self) -> list[dict]:
        with self.lock:
            return [dict(r) for r in self.rows.values()]


def table_snapshot(table: Table) -> _SnapshotCollector:
    """A live snapshot collector over ``table`` (works without bokeh/panel)."""
    return _SnapshotCollector(table)


def plot(table: Table, plotting_function: Callable, sorting_col: Any = None) -> Any:
    """A bokeh plot of ``table`` that follows its updates."""
    _require_bokeh()
    import pandas as pd
    import panel as pn
    from bokeh.models import ColumnDataSource

    collector = _SnapshotCollector(table)
    source = ColumnDataSource(pd.DataFrame(collector.snapshot()))
    figure = plotting_function(source)

    def refresh(current: list) -> None:
        df = pd.DataFrame(current)
        if sorting_col is not None and sorting_col in df:
            df = df.sort_values(sorting_col)
        source.data = dict(ColumnDataSource(df).data)

    collector.listeners.append(refresh)
    return pn.Column(figure)


def show(table: Table, **kwargs: Any) -> Any:
    """A live table widget of ``table``."""
    _require_bokeh()
    import pandas as pd
    import panel as pn

    collector = _SnapshotCollector(table)
    widget = pn.widgets.Tabulator(pd.DataFrame(collector.snapshot()), **kwargs)

    def refresh(current: list) -> None:
        widget.value = pd.DataFrame(current)

    collector.listeners.append(refresh)
    return widget
