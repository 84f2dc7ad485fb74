"""Column utilities (port of ``pathway_tpu/stdlib/utils/col.py``)."""

from __future__ import annotations

from typing import Any, Callable, Sequence

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def _out_name(n: Any) -> str:
    return n.name if hasattr(n, "name") else str(n)


def unpack_col(column: expr.ColumnReference, *unpacked_columns: Any, schema: Any = None) -> Table:
    """Explode a tuple column into named columns."""
    table = column.table
    if schema is not None:
        names = schema.column_names()
    else:
        names = [_out_name(c) for c in unpacked_columns]
    exprs = {name: column[i] for i, name in enumerate(names)}
    return table.select(**exprs)


def multiapply_all_rows(
    *cols: expr.ColumnReference,
    fun: Callable[..., list[Sequence]],
    result_col_names: list[Any],
) -> Table:
    """Apply ``fun`` to entire columns at once (all rows together), producing several
    result columns keyed like the input table.

    The whole table is folded
    into one row (a sorted tuple of ``(id, *values)`` rows), the function runs once per
    commit over the materialized columns, and the results are flattened back out and
    re-keyed by the original row ids. Meant for small tables / infrequent updates.
    """
    assert cols, "multiapply_all_rows needs at least one column"
    table = cols[0].table

    zipped = table.select(
        _pw_row=expr.apply(lambda *parts: tuple(parts), table.id, *cols)
    )
    reduced = zipped.reduce(_pw_rows=reducers.sorted_tuple(zipped._pw_row))

    names = [_out_name(n) for n in result_col_names]

    def fun_wrapped(rows: tuple) -> tuple:
        if not rows:
            return ()
        ids, *colvals = zip(*rows)
        results = [list(col) for col in fun(*[list(c) for c in colvals])]
        if len(results) != len(names):
            raise ValueError(
                f"multiapply_all_rows: fun returned {len(results)} columns, "
                f"expected {len(names)}"
            )
        for col in results:
            if len(col) != len(ids):
                raise ValueError(
                    f"multiapply_all_rows: fun returned a column of length {len(col)} "
                    f"for {len(ids)} input rows"
                )
        return tuple(zip(ids, *results))

    applied = reduced.select(_pw_out=expr.apply(fun_wrapped, reduced._pw_rows))
    flattened = applied.flatten(applied._pw_out)
    unpacked = unpack_col(flattened._pw_out, "_pw_id", *names)
    result = unpacked.with_id(unpacked._pw_id).without("_pw_id")
    result.promise_universe_is_equal_to(table)
    return result.with_universe_of(table)


def apply_all_rows(
    *cols: expr.ColumnReference,
    fun: Callable[..., Sequence],
    result_col_name: Any,
) -> Table:
    """Single-result-column variant of :func:`multiapply_all_rows`."""

    def fun_wrapped(*colvals: list) -> list[Sequence]:
        return [fun(*colvals)]

    return multiapply_all_rows(*cols, fun=fun_wrapped, result_col_names=[result_col_name])


def groupby_reduce_majority(column: expr.ColumnReference, value_column: expr.ColumnReference) -> Table:
    table = column.table

    value_column = table[value_column]
    counted = table.groupby(column, value_column).reduce(
        column, value_column, _pw_count=reducers.count()
    )
    from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows

    winners = argmax_rows(counted, counted[column.name], what=counted._pw_count)
    return winners.select(
        winners[column.name], majority=winners[value_column.name]
    )


def flatten_column(
    column: expr.ColumnReference,
    origin_id: "str | None" = "origin_id",
) -> Table:
    """Deprecated alias for ``Table.flatten``."""
    import warnings

    warnings.warn(
        "pw.stdlib.utils.col.flatten_column() is deprecated, use "
        "pw.Table.flatten() instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return column.table.flatten(column, origin_id=origin_id)


def unpack_col_dict(column: expr.ColumnReference, schema: Any) -> Table:
    """Json-object column -> typed columns per ``schema``; absent fields become None (optional dtypes)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.json import Json

    table = column.table
    cols = {}
    for name, cs in schema.columns().items():
        target = cs.dtype

        def getter(cell: Any, _n: str = name, _t: Any = target) -> Any:
            obj = cell.value if isinstance(cell, Json) else cell
            v = (obj or {}).get(_n)
            if v is None:
                return None
            if _t.strip_optional() == dt.JSON:
                return Json(v)
            return v

        cols[name] = pw.apply_with_type(getter, target, column)
    return table.select(**cols)
