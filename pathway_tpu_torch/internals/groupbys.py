"""GroupedTable: the groupby → reduce surface (port of ``pathway_tpu/internals/groupbys.py``)."""

from __future__ import annotations

from typing import Any, Dict, List

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.parse_graph import G


class GroupedTable:
    def __init__(
        self,
        table: Any,
        grouping: List[expr.ColumnExpression],
        grouping_names: List[str],
        set_id: bool = False,
        sort_by: expr.ColumnExpression | None = None,
    ):
        self._table = table
        self._grouping = grouping
        self._grouping_names = grouping_names
        self._set_id = set_id
        self._sort_by = sort_by

    def _resolve(self, e: Any) -> expr.ColumnExpression:
        e = thisclass.substitute(e, {thisclass.this: self._table})
        return expr.smart_coerce(e)

    def reduce(self, *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.internals.table import Table, _name_of
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        out_exprs: Dict[str, expr.ColumnExpression] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = self._resolve(arg)
        for name, e in kwargs.items():
            out_exprs[name] = self._resolve(e)

        columns: Dict[str, sch.ColumnSchema] = {}
        for name, e in out_exprs.items():
            if isinstance(e, expr.ReducerExpression):
                arg_dtypes = [infer_dtype(a) for a in e._args]
                dtype = e._reducer.return_dtype(arg_dtypes)
            elif isinstance(e, expr.ColumnReference):
                # must be a grouping column
                dtype = infer_dtype(e)
            else:
                dtype = infer_dtype(e)
            columns[name] = sch.ColumnSchema(name, dtype)
        schema = sch.schema_from_columns(columns, "reduce")

        node = G.add_node(
            pg.GroupbyNode(
                inputs=[self._table],
                grouping=self._grouping,
                grouping_names=self._grouping_names,
                out_exprs=out_exprs,
                set_id=self._set_id,
                sort_by=self._sort_by,
            )
        )
        return Table(node, schema, name="reduce")
