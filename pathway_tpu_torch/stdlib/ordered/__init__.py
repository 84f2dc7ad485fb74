"""Ordered-stream helpers (port of ``pathway_tpu/stdlib/ordered``): ``diff``."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.expression as expr
from pathway_tpu_torch.internals.table import Table


def diff(table: Table, timestamp: Any, *values: Any, instance: Any = None) -> Table:
    """Per-row difference vs the previous row when ordered by ``timestamp``.

    Produces ``diff_<name>`` columns (None for the first row of each instance).
    """
    sorted_t = table.sort(timestamp, instance=instance)
    prev_table = table.ix(sorted_t.prev, optional=True)
    out_exprs: dict[str, Any] = {}
    for v in values:
        name = v.name if hasattr(v, "name") else str(v)
        out_exprs["diff_" + name] = expr.require(table[name] - prev_table[name], prev_table[name])
    return table.with_columns(**out_exprs)
