"""Null sink (port of ``pathway_tpu/io/null.py``): the table's deltas are
computed up to the sink and dropped, with no per-row Python objects."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.parse_graph import G


def write(table: Any, name: str | None = None) -> None:
    def batch_callback(keys: Any, diffs: Any, columns: dict, time: int) -> None:
        pass

    G.add_node(pg.OutputNode(inputs=[table], batch_callback=batch_callback))
