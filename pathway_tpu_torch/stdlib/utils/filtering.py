"""Row-filtering helpers (port of ``pathway_tpu/stdlib/utils/filtering.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def argmax_rows(table: Table, *on: expr.ColumnReference, what: Any) -> Table:
    """Keep, per group defined by ``on``, the single row maximizing ``what``."""
    reduced = table.groupby(*on).reduce(argmax_id=reducers.argmax(what))
    filter_table = reduced.with_id(reduced.argmax_id).promise_universe_is_subset_of(table)
    return table.restrict(filter_table)


def argmin_rows(table: Table, *on: expr.ColumnReference, what: Any) -> Table:
    """Keep, per group defined by ``on``, the single row minimizing ``what``."""
    reduced = table.groupby(*on).reduce(argmin_id=reducers.argmin(what))
    filter_table = reduced.with_id(reduced.argmin_id).promise_universe_is_subset_of(table)
    return table.restrict(filter_table)
