"""CSV connector (port of ``pathway_tpu/io/csv.py``): ``fs`` with ``format="csv"``."""

from __future__ import annotations

import csv as _csv
import threading
from pathlib import Path
from typing import Any

from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io import fs


class CsvParserSettings:
    def __init__(
        self, delimiter: str = ",", quote: str = '"', escape: str | None = None, **kw: Any
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape


def read(
    path: str | Path,
    *,
    schema: Any = None,
    mode: str = "streaming",
    csv_settings: CsvParserSettings | None = None,
    **kwargs: Any,
):
    return fs.read(
        path, format="csv", schema=schema, mode=mode, csv_settings=csv_settings, **kwargs
    )


def write(table: Any, filename: str | Path, **kwargs: Any) -> None:
    """The table's update stream as CSV: its columns, then ``time`` and ``diff``."""
    f = open(str(filename), "w", newline="")
    names = table.column_names()
    writer = _csv.writer(f)
    writer.writerow(names + ["time", "diff"])
    lock = threading.Lock()

    def callback(key: Any, row: dict, time: int, is_addition: bool) -> None:
        with lock:
            writer.writerow([row[n] for n in names] + [time, 1 if is_addition else -1])
            f.flush()

    G.add_node(pg.OutputNode(inputs=[table], callback=callback, on_end=f.close))
