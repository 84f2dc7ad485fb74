"""User-facing relational Table API (port of ``pathway_tpu/internals/table.py``).

The declarative surface lowers to graph nodes that the engine runs
incrementally over batch deltas: ``select`` / ``with_columns`` / ``rename``,
``filter`` / ``split``, ``flatten``, ``concat`` / ``concat_reindex``,
``with_id`` / ``with_id_from``, ``groupby`` / ``reduce``, ``deduplicate``,
joins, ``ix`` / ``ix_ref``, ``having``, ``update_rows`` / ``update_cells``,
``intersect`` / ``difference`` / ``restrict``, ``with_universe_of`` and the
universe promises, ``sort``, ``remove_errors``, the gradual broadcast, the
time-threshold operators behind ``pw.temporal`` and ``windowby`` / the
temporal joins, and ``diff`` / ``interpolate``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.parse_graph import G, Universe, new_universe, universe_solver


class Joinable:
    """Common base for Table and JoinResult (reference ``Joinable``)."""


def _name_of(arg: Any) -> str:
    if isinstance(arg, expr.ColumnReference):
        return arg.name
    if isinstance(arg, thisclass.ThisColumnReference):
        return arg.name
    if isinstance(arg, str):
        return arg
    raise ValueError(f"cannot infer a column name from {arg!r}")


class Table(Joinable):
    """A keyed collection of rows with typed columns, updated incrementally."""

    def __init__(
        self,
        node: pg.Node,
        schema: sch.SchemaMetaclass,
        universe: Universe | None = None,
        name: str = "table",
    ):
        self._node = node
        self._schema = schema
        self._universe = universe if universe is not None else new_universe()
        self._name = name
        node.output = self

    # -- metadata -----------------------------------------------------------

    @property
    def schema(self) -> sch.SchemaMetaclass:
        return self._schema

    @property
    def id(self) -> expr.ColumnReference:
        return expr.ColumnReference(self, "id")

    def column_names(self) -> list[str]:
        return self._schema.column_names()

    def keys(self) -> Dict[str, sch.ColumnSchema]:
        return self._schema.columns()

    def typehints(self) -> Dict[str, Any]:
        return self._schema.typehints()

    def __repr__(self) -> str:
        return f"<pw.Table {self._name!r} schema={self._schema!r}>"

    # -- column access ------------------------------------------------------

    def __getattr__(self, name: str) -> expr.ColumnReference:
        if name.startswith("__") or name in ("_node", "_schema", "_universe", "_name"):
            raise AttributeError(name)
        if name not in self._schema.columns():
            raise AttributeError(f"table has no column {name!r}; columns: {self.column_names()}")
        return expr.ColumnReference(self, name)

    def __getitem__(self, name: Any) -> Any:
        if isinstance(name, (list, tuple)):
            return [self[n] for n in name]
        if isinstance(name, expr.ColumnReference):
            name = name.name
        if isinstance(name, thisclass.ThisColumnReference):
            name = name.name
        if name == "id":
            return self.id
        if name not in self._schema.columns():
            raise KeyError(f"table has no column {name!r}; columns: {self.column_names()}")
        return expr.ColumnReference(self, name)

    def __iter__(self):
        raise TypeError("Table is not iterable; use pw.debug helpers to inspect contents")

    # -- desugaring ---------------------------------------------------------

    @property
    def C(self) -> "Table":
        return self

    # -- desugaring ---------------------------------------------------------

    def _resolve(self, e: Any) -> expr.ColumnExpression:
        e = thisclass.substitute(e, {thisclass.this: self})
        return expr.smart_coerce(e)

    def _infer_dtype(self, e: expr.ColumnExpression) -> dt.DType:
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        return infer_dtype(e)

    def _make_output_schema(self, exprs: Dict[str, expr.ColumnExpression], name: str) -> sch.SchemaMetaclass:
        columns = {
            out_name: sch.ColumnSchema(out_name, self._infer_dtype(e))
            for out_name, e in exprs.items()
        }
        return sch.schema_from_columns(columns, name=name)

    # -- core ops -----------------------------------------------------------

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        """Project/compute columns; keys are preserved (reference ``table.py`` select)."""
        from pathway_tpu_torch.internals.thisclass import ThisWildcard

        exprs: Dict[str, expr.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ThisWildcard):
                from pathway_tpu_torch.internals import thisclass as _tc

                if arg._kind is not _tc.this:
                    raise TypeError(
                        f"*pw.{arg._kind.__name__} wildcards only apply inside a "
                        "join's select; use *pw.this on a plain table"
                    )
                # ``*pw.this`` / ``*pw.this.without(...)``: all columns except
                # the exclusions; later kwargs may shadow individual names
                for n in self.column_names():
                    if n not in arg._exclude:
                        exprs[n] = self[n]
                continue
            exprs[_name_of(arg)] = self._resolve(arg)
        for out_name, e in kwargs.items():
            exprs[out_name] = self._resolve(e)
        node = G.add_node(pg.RowwiseNode(inputs=[self], exprs=exprs))
        out_schema = self._make_output_schema(exprs, "select")
        result = Table(node, out_schema, universe=self._universe, name="select")
        node.config["exprs"] = exprs
        return result

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        existing: Dict[str, Any] = {name: self[name] for name in self.column_names()}
        for arg in args:
            existing[_name_of(arg)] = arg
        existing.update(kwargs)
        return self.select(**existing)

    def without(self, *columns: Any) -> "Table":
        drop = {_name_of(c) for c in columns}
        keep = {n: self[n] for n in self.column_names() if n not in drop}
        return self.select(**keep)

    def rename_columns(self, **kwargs: Any) -> "Table":
        # new_name=old_column
        mapping = {new: _name_of(old) for new, old in kwargs.items()}
        exprs = {n: self[n] for n in self.column_names() if n not in mapping.values()}
        for new, old in mapping.items():
            exprs[new] = self[old]
        return self.select(**exprs)

    def rename_by_dict(self, names_mapping: Mapping[Any, str]) -> "Table":
        mapping = {_name_of(old): new for old, new in names_mapping.items()}
        exprs = {mapping.get(n, n): self[n] for n in self.column_names()}
        return self.select(**exprs)

    def rename(self, names_mapping: Mapping[Any, str] | None = None, **kwargs: Any) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def filter(self, filter_expression: Any) -> "Table":
        e = self._resolve(filter_expression)
        for ref in e._column_refs:
            if ref.table is self or ref.table._universe is self._universe:
                continue
            if universe_solver.query_are_equal(ref.table._universe, self._universe):
                continue
            # resolving a foreign-universe column per THIS table's row keys
            # would silently produce misses (reference raises the same way)
            raise ValueError(
                f"filter: column {ref.name!r} belongs to a table with a "
                "different universe; use promise_universes_are_equal or filter "
                "on this table's own columns"
            )
        node = G.add_node(pg.FilterNode(inputs=[self], expression=e))
        result = Table(node, self._schema, name="filter")
        universe_solver.register_subset(result._universe, self._universe)
        return result

    # -- groupby / reduce ---------------------------------------------------

    def split(self, split_expression: Any) -> tuple["Table", "Table"]:
        positive = self.filter(split_expression)
        negative = self.filter(~self._resolve(split_expression))
        return positive, negative

    def copy(self) -> "Table":
        return self.select(**{n: self[n] for n in self.column_names()})

    # -- groupby / reduce ---------------------------------------------------

    def groupby(
        self,
        *args: Any,
        id: Any = None,
        sort_by: Any = None,
        instance: Any = None,
        **kwargs: Any,
    ) -> "GroupedTable":
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        grouping = [self._resolve(a) for a in args]
        names = [_name_of(a) for a in args]
        if instance is not None:
            grouping.append(self._resolve(instance))
            names.append(_name_of(instance))
        if id is not None:
            grouping = [self._resolve(id)]
            names = ["id"]
        return GroupedTable(
            self,
            grouping,
            names,
            set_id=id is not None,
            sort_by=self._resolve(sort_by) if sort_by is not None else None,
        )

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any = None,
        instance: Any = None,
        acceptor: Callable[[Any, Any], bool] | None = None,
        persistent_id: str | None = None,
        name: str | None = None,
    ) -> "Table":
        """Keep one row per instance, advancing only when ``acceptor(new, old)``
        accepts."""
        value_e = self._resolve(value) if value is not None else None
        instance_e = self._resolve(instance) if instance is not None else None
        node = G.add_node(
            pg.DeduplicateNode(
                inputs=[self], value=value_e, instance=instance_e, acceptor=acceptor
            )
        )
        return Table(node, self._schema, name="deduplicate")

    # -- joins --------------------------------------------------------------

    def join(
        self,
        other: "Table",
        *on: Any,
        id: Any = None,
        how: Any = None,
        left_instance: Any = None,
        right_instance: Any = None,
    ) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinKind, JoinResult

        kind = how if how is not None else JoinKind.INNER
        return JoinResult(
            self, other, on, kind, id=id, left_instance=left_instance, right_instance=right_instance
        )

    def join_inner(self, other: "Table", *on: Any, **kw: Any) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinKind

        return self.join(other, *on, how=JoinKind.INNER, **kw)

    def join_left(self, other: "Table", *on: Any, **kw: Any) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinKind

        return self.join(other, *on, how=JoinKind.LEFT, **kw)

    def join_right(self, other: "Table", *on: Any, **kw: Any) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinKind

        return self.join(other, *on, how=JoinKind.RIGHT, **kw)

    def join_outer(self, other: "Table", *on: Any, **kw: Any) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinKind

        return self.join(other, *on, how=JoinKind.OUTER, **kw)

    # -- pointer ops --------------------------------------------------------

    def pointer_from(self, *args: Any, optional: bool = False, instance: Any = None) -> expr.PointerExpression:
        return expr.PointerExpression(
            self,
            *[self._resolve(a) for a in args],
            optional=optional,
            instance=instance,
        )

    def ix(
        self,
        expression: Any,
        *,
        optional: bool = False,
        context: Any = None,
        allow_misses: bool = False,
    ) -> "Table":
        """Rows of this table at the pointers in another table's column, keyed
        like that table (the lookup ``DataIndex`` enriches matches with)."""
        key_expr = expr.smart_coerce(expression)
        refs = key_expr._column_refs
        if context is not None:
            # constant-key lookups broadcast across an explicit calling table
            source = context
        elif refs:
            source = refs[0].table
        elif isinstance(key_expr, expr.PointerExpression):
            # a zero-argument pointer_from still knows its table
            source = key_expr._table
        else:
            raise ValueError("ix requires an expression over some table's columns")
        node = G.add_node(
            pg.IxNode(
                inputs=[source, self],
                key_expression=key_expr,
                optional=optional or allow_misses,
            )
        )
        return Table(node, self._schema, universe=source._universe, name="ix")

    def ix_ref(self, *args: Any, optional: bool = False, context: Any = None, instance: Any = None) -> "Table":
        """Row lookup by primary-key values: ``t.ix_ref(q.key)`` re-keys through ``t.pointer_from`` — matching keys
        assigned by ``with_id_from``/primary-key schemas. Constant args
        broadcast the looked-up row across ``context``'s universe (pass
        ``context=...`` when calling from another table; without it the
        broadcast spans the target's own universe)."""
        return self.ix(
            self.pointer_from(*args, instance=instance), optional=optional, context=context
        )

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column: expr.ColumnReference,
        value_column: expr.ColumnReference,
        upper_column: expr.ColumnReference,
    ) -> "Table":
        """Add an ``apx_value`` column broadcasting the threshold table's
        (lower, value, upper) band with a per-key stagger and hysteresis."""
        from pathway_tpu_torch.internals import dtype as dt_mod
        from pathway_tpu_torch.internals import schema as sch_mod

        node = G.add_node(
            pg.GradualBroadcastNode(
                inputs=[self, threshold_table],
                lower=lower_column.name,
                value=value_column.name,
                upper=upper_column.name,
            )
        )
        schema = sch_mod.schema_from_columns(
            {
                **self._schema.columns(),
                "apx_value": sch_mod.ColumnSchema("apx_value", dt_mod.FLOAT),
            },
            name="gradual_broadcast",
        )
        result = Table(node, schema, name="gradual_broadcast")
        universe_solver.register_subset(result._universe, self._universe)
        return result


    def having(self, *indexers: expr.ColumnReference) -> "Table":
        """Rows whose key is among the values of the indexer pointer columns."""
        # the indexer tables are inputs: their deltas drive the counts
        node = G.add_node(
            pg.HavingNode(inputs=[self, *(ix.table for ix in indexers)], indexers=list(indexers))
        )
        result = Table(node, self._schema, name="having")
        universe_solver.register_subset(result._universe, self._universe)
        return result

    # -- universe ops -------------------------------------------------------

    def update_rows(self, other: "Table") -> "Table":
        """Union of rows; on a key both hold, ``other``'s row wins."""
        schema = _merge_schema_strict(self._schema, other._schema, "update_rows")
        node = G.add_node(pg.UpdateRowsNode(inputs=[self, other]))
        result = Table(node, schema, name="update_rows")
        universe_solver.register_union(result._universe, [self._universe, other._universe])
        return result

    def update_cells(self, other: "Table") -> "Table":
        """Update values of other's columns on matching keys (other ⊆ self)."""
        unknown = [c for c in other.column_names() if c not in self.column_names()]
        if unknown:
            # silently ignoring them would make typos no-ops (reference raises)
            raise ValueError(
                f"update_cells: column(s) {unknown} do not exist in the updated "
                f"table (columns: {self.column_names()})"
            )
        node = G.add_node(pg.UpdateCellsNode(inputs=[self, other]))
        return Table(node, self._schema, universe=self._universe, name="update_cells")

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def concat(self, *others: "Table") -> "Table":
        """Disjoint union of rows; runtime error on key clash."""
        tables = [self, *others]
        schema = tables[0]._schema
        for t in tables[1:]:
            schema = _merge_schema_strict(schema, t._schema, "concat")
        node = G.add_node(pg.ConcatNode(inputs=tables, reindex=False))
        result = Table(node, schema, name="concat")
        universe_solver.register_union(
            result._universe, [t._universe for t in tables]
        )
        return result

    def intersect(self, *others: "Table") -> "Table":
        node = G.add_node(pg.IntersectNode(inputs=[self, *others]))
        result = Table(node, self._schema, name="intersect")
        universe_solver.register_intersection(
            result._universe, [self._universe, *(o._universe for o in others)]
        )
        return result

    def difference(self, other: "Table") -> "Table":
        node = G.add_node(pg.DifferenceNode(inputs=[self, other]))
        result = Table(node, self._schema, name="difference")
        universe_solver.register_difference(result._universe, self._universe, other._universe)
        return result

    def restrict(self, other: "Table") -> "Table":
        if not universe_solver.query_is_subset(other._universe, self._universe):
            raise ValueError(
                "table.restrict(other): other's universe is not a subset of table's; "
                "use promise_universe_is_subset_of first"
            )
        node = G.add_node(pg.RestrictNode(inputs=[self, other]))
        return Table(node, self._schema, universe=other._universe, name="restrict")

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        schema = tables[0]._schema
        for t in tables[1:]:
            schema = _merge_schema_strict(schema, t._schema, "concat_reindex")
        node = G.add_node(pg.ConcatNode(inputs=tables, reindex=True))
        return Table(node, schema, name="concat_reindex")

    def with_universe_of(self, other: "Table") -> "Table":
        if not universe_solver.query_are_equal(self._universe, other._universe):
            raise ValueError(
                "with_universe_of: universes not known to be equal; "
                "use promise_universes_are_equal first"
            )
        node = G.add_node(pg.WithUniverseOfNode(inputs=[self, other]))
        return Table(node, self._schema, universe=other._universe, name="with_universe_of")

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        universe_solver.register_disjoint(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        universe_solver.register_subset(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        universe_solver.register_equal(self._universe, other._universe)
        return self

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        return self.promise_universe_is_equal_to(other)

    # -- reindex ------------------------------------------------------------

    def with_id(self, new_index: Any) -> "Table":
        e = self._resolve(new_index)
        node = G.add_node(pg.ReindexNode(inputs=[self], expression=e))
        return Table(node, self._schema, name="with_id")

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        e = self.pointer_from(*args, instance=instance)
        return self.with_id(e)


    # -- flatten -----------------------------------------------------

    def flatten(self, to_flatten: Any, *, origin_id: str | None = None) -> "Table":
        flat_ref = self._resolve(to_flatten)
        name = _name_of(to_flatten)
        node = G.add_node(
            pg.FlattenNode(inputs=[self], expression=flat_ref, flat_name=name, origin_id=origin_id)
        )
        columns = dict(self._schema.columns())
        inner = columns[name].dtype
        if isinstance(inner, dt.List_):
            columns[name] = sch.ColumnSchema(name, inner.wrapped)
        elif isinstance(inner, dt.Tuple_) and inner.args:
            columns[name] = sch.ColumnSchema(name, inner.args[0])
        elif inner == dt.STR:
            columns[name] = sch.ColumnSchema(name, dt.STR)
        else:
            columns[name] = sch.ColumnSchema(name, dt.ANY)
        if origin_id:
            columns[origin_id] = sch.ColumnSchema(origin_id, dt.POINTER)
        schema = sch.schema_from_columns(columns, "flatten")
        return Table(node, schema, name="flatten")

    def sort(self, key: Any, instance: Any = None) -> "Table":
        key_e = self._resolve(key)
        instance_e = self._resolve(instance) if instance is not None else None
        node = G.add_node(pg.SortNode(inputs=[self], key=key_e, instance=instance_e))
        columns = {
            "prev": sch.ColumnSchema("prev", dt.Optional_(dt.POINTER)),
            "next": sch.ColumnSchema("next", dt.Optional_(dt.POINTER)),
        }
        schema = sch.schema_from_columns(columns, "sort")
        return Table(node, schema, universe=self._universe, name="sort")

    # -- typing -------------------------------------------------------------

    def cast_to_types(self, **kwargs: Any) -> "Table":
        exprs = {
            n: (expr.cast(kwargs[n], self[n]) if n in kwargs else self[n])
            for n in self.column_names()
        }
        return self.select(**exprs)

    def update_types(self, **kwargs: Any) -> "Table":
        exprs = {
            n: (expr.declare_type(kwargs[n], self[n]) if n in kwargs else self[n])
            for n in self.column_names()
        }
        return self.select(**exprs)

    # -- slicing ------------------------------------------------------------

    @property
    def slice(self) -> "TableSlice":
        return TableSlice(self, {n: self[n] for n in self.column_names()})

    # -- errors -------------------------------------------------------------

    def remove_errors(self) -> "Table":
        node = G.add_node(pg.RemoveErrorsNode(inputs=[self]))
        result = Table(node, self._schema, name="remove_errors")
        universe_solver.register_subset(result._universe, self._universe)
        return result

    # -- the time-threshold operators ----------------------------------------

    def _buffer(self, threshold: Any, time: Any) -> "Table":
        """Postpone rows until the stream's time passes ``threshold``."""
        node = G.add_node(
            pg.BufferNode(inputs=[self], threshold=self._resolve(threshold), time=self._resolve(time))
        )
        return Table(node, self._schema, name="buffer")

    def _freeze(self, threshold: Any, time: Any) -> "Table":
        """Ignore rows arriving after the stream's time passed ``threshold``."""
        node = G.add_node(
            pg.FreezeNode(inputs=[self], threshold=self._resolve(threshold), time=self._resolve(time))
        )
        result = Table(node, self._schema, name="freeze")
        universe_solver.register_subset(result._universe, self._universe)
        return result

    def _forget(self, threshold: Any, time: Any, mark_forgetting_records: bool = True) -> "Table":
        """Retract rows once the stream's time passes ``threshold``."""
        node = G.add_node(
            pg.ForgetNode(
                inputs=[self],
                threshold=self._resolve(threshold),
                time=self._resolve(time),
                mark=mark_forgetting_records,
            )
        )
        return Table(node, self._schema, name="forget")

    def _forget_immediately(self) -> "Table":
        node = G.add_node(pg.AsofNowUpdateNode(inputs=[self], mode="forget"))
        return Table(node, self._schema, name="forget_immediately")

    def _filter_out_results_of_forgetting(self) -> "Table":
        node = G.add_node(pg.AsofNowUpdateNode(inputs=[self], mode="filter_forgotten"))
        return Table(node, self._schema, name="filter_out_forgetting")

    def _external_index_as_of_now(
        self,
        index_table: "Table",
        *,
        index_column: expr.ColumnReference,
        query_column: expr.ColumnReference,
        index_factory: Any,
        res_type: dt.DType = dt.ANY,
        query_responses_limit_column: expr.ColumnReference | None = None,
        index_filter_data_column: expr.ColumnReference | None = None,
        query_filter_column: expr.ColumnReference | None = None,
        asof_now: bool = True,
    ) -> "Table":
        """Query a pluggable external index. ``self`` is the query table. With ``asof_now=False``
        live queries are re-answered when the index changes."""
        node = G.add_node(
            pg.ExternalIndexNode(
                inputs=[index_table, self],
                index_column=index_column,
                query_column=query_column,
                index_factory=index_factory,
                query_responses_limit_column=query_responses_limit_column,
                index_filter_data_column=index_filter_data_column,
                query_filter_column=query_filter_column,
                asof_now=asof_now,
            )
        )
        columns = {"_pw_index_reply": sch.ColumnSchema("_pw_index_reply", res_type)}
        schema = sch.schema_from_columns(columns, "external_index")
        return Table(node, schema, universe=self._universe, name="external_index")

    # -- pw.temporal entry points -------------------------------------------

    def windowby(self, time_expr: Any, *, window: Any, behavior: Any = None, instance: Any = None, **kwargs: Any):
        from pathway_tpu_torch.stdlib.temporal import windowby as _windowby

        return _windowby(self, time_expr, window=window, behavior=behavior, instance=instance, **kwargs)

    def interval_join(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import interval_join as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_inner(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import interval_join_inner as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_left(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import interval_join_left as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_right(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import interval_join_right as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_outer(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import interval_join_outer as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def window_join(self, other: "Table", self_time: Any, other_time: Any, window: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import window_join as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_inner(self, other: "Table", self_time: Any, other_time: Any, window: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import window_join_inner as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_left(self, other: "Table", self_time: Any, other_time: Any, window: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import window_join_left as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_right(self, other: "Table", self_time: Any, other_time: Any, window: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import window_join_right as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_outer(self, other: "Table", self_time: Any, other_time: Any, window: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import window_join_outer as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def asof_join(self, other: "Table", self_time: Any, other_time: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_join as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_inner(self, other: "Table", self_time: Any, other_time: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_join_inner as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_left(self, other: "Table", self_time: Any, other_time: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_join_left as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_right(self, other: "Table", self_time: Any, other_time: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_join_right as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_outer(self, other: "Table", self_time: Any, other_time: Any, *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_join_outer as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_now_join(self, other: "Table", *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join as _f

        return _f(self, other, *on, **kw)

    def asof_now_join_inner(self, other: "Table", *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join_inner as _f

        return _f(self, other, *on, **kw)

    def asof_now_join_left(self, other: "Table", *on: Any, **kw: Any):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join_left as _f

        return _f(self, other, *on, **kw)


    def diff(self, timestamp: Any, *values: Any, instance: Any = None) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    def interpolate(self, timestamp: Any, *values: Any, mode: Any = None) -> "Table":
        from pathway_tpu_torch.stdlib.statistical import interpolate as _interpolate

        return _interpolate(self, timestamp, *values, mode=mode)


class TableSlice:
    """A named-column view of a table (``table.slice``)."""

    def __init__(self, table: Table, mapping: Dict[str, expr.ColumnReference]):
        self._table = table
        self._mapping = mapping

    def __iter__(self):
        return iter(self._mapping.values())

    def keys(self) -> list[str]:
        return list(self._mapping)

    def __getitem__(self, name: str) -> expr.ColumnReference:
        return self._mapping[name]

    def __getattr__(self, name: str) -> expr.ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._mapping[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def without(self, *cols: Any) -> "TableSlice":
        drop = {_name_of(c) for c in cols}
        return TableSlice(self._table, {k: v for k, v in self._mapping.items() if k not in drop})

    def with_prefix(self, prefix: str) -> "TableSlice":
        return TableSlice(self._table, {prefix + k: v for k, v in self._mapping.items()})

    def with_suffix(self, suffix: str) -> "TableSlice":
        return TableSlice(self._table, {k + suffix: v for k, v in self._mapping.items()})

    def rename(self, names_mapping: Mapping[str, str]) -> "TableSlice":
        return TableSlice(
            self._table,
            {names_mapping.get(k, k): v for k, v in self._mapping.items()},
        )


def _merge_schema_strict(
    a: sch.SchemaMetaclass, b: sch.SchemaMetaclass, op: str
) -> sch.SchemaMetaclass:
    a_cols, b_cols = a.columns(), b.columns()
    if set(a_cols) != set(b_cols):
        raise ValueError(
            f"{op}: column sets differ: {sorted(a_cols)} vs {sorted(b_cols)}"
        )
    merged = {
        n: sch.ColumnSchema(n, dt.types_lca(a_cols[n].dtype, b_cols[n].dtype))
        for n in a_cols
    }
    return sch.schema_from_columns(merged, op)
