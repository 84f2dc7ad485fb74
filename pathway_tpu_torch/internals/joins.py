"""Join builder & desugaring (port of ``pathway_tpu/internals/joins.py``).

The engine runs joins as incremental symmetric hash joins
(``engine/evaluators.py``); the port's slice uses inner and left joins.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.parse_graph import G


class JoinKind(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


# alias matching reference pw.JoinMode
JoinMode = JoinKind


class JoinResult:
    """Intermediate result of ``t1.join(t2, ...)``; call ``.select`` to materialize."""

    def __init__(
        self,
        left: Any,
        right: Any,
        on: tuple,
        kind: JoinKind,
        id: Any = None,
        left_instance: Any = None,
        right_instance: Any = None,
    ):
        self._left = left
        self._right = right
        self._kind = kind
        self._id = id
        self._left_on: List[expr.ColumnExpression] = []
        self._right_on: List[expr.ColumnExpression] = []
        for cond in on:
            l, r = self._split_condition(cond)
            self._left_on.append(l)
            self._right_on.append(r)
        if left_instance is not None or right_instance is not None:
            if left_instance is None or right_instance is None:
                raise ValueError("both left_instance and right_instance must be given")
            self._left_on.append(self._sub_left(left_instance))
            self._right_on.append(self._sub_right(right_instance))

    def _sub_left(self, e: Any) -> expr.ColumnExpression:
        e = thisclass.substitute(
            e, {thisclass.this: self._left, thisclass.left: self._left, thisclass.right: self._right}
        )
        return expr.smart_coerce(e)

    def _sub_right(self, e: Any) -> expr.ColumnExpression:
        e = thisclass.substitute(
            e, {thisclass.this: self._right, thisclass.left: self._left, thisclass.right: self._right}
        )
        return expr.smart_coerce(e)

    def _side_of(self, e: expr.ColumnExpression) -> str:
        refs = e._column_refs
        sides = set()
        for ref in refs:
            if ref.table is self._left:
                sides.add("left")
            elif ref.table is self._right:
                sides.add("right")
            else:
                raise ValueError(
                    f"join condition references table {ref.table._name!r} which is not a join side"
                )
        if len(sides) != 1:
            raise ValueError(f"join condition side is ambiguous: {e!r}")
        return sides.pop()

    def _split_condition(self, cond: Any) -> tuple:
        cond = thisclass.substitute(
            cond, {thisclass.left: self._left, thisclass.right: self._right}
        )
        if not isinstance(cond, expr.ColumnBinaryOpExpression):
            raise ValueError(f"join condition must be <left expr> == <right expr>, got {cond!r}")
        import operator

        if cond._operator is not operator.eq:
            raise ValueError("join conditions must use ==")
        a, b = cond._left, cond._right
        if self._side_of(a) == "left":
            return a, b
        return b, a

    def select(self, *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.internals.table import Table, _name_of
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        out: Dict[str, expr.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, thisclass.ThisWildcard):
                # *pw.left / *pw.right: that side's columns; *pw.this: both
                # sides' (left wins a name clash, as in the reference)
                sides = {
                    thisclass.left: [self._left],
                    thisclass.right: [self._right],
                    thisclass.this: [self._left, self._right],
                }[arg._kind]
                for side in sides:
                    for n in side.column_names():
                        if n not in arg._exclude and n not in out:
                            out[n] = expr.smart_coerce(side[n])
                continue
            resolved = thisclass.substitute(
                arg,
                {thisclass.this: _JoinThis(self), thisclass.left: self._left, thisclass.right: self._right},
            )
            out[_name_of(arg)] = expr.smart_coerce(resolved)
        for name, e in kwargs.items():
            resolved = thisclass.substitute(
                e,
                {thisclass.this: _JoinThis(self), thisclass.left: self._left, thisclass.right: self._right},
            )
            out[name] = expr.smart_coerce(resolved)

        id_expr = None
        if self._id is not None:
            id_expr = self._sub_left(self._id) if self._side_is_left_safe(self._id) else self._sub_right(self._id)

        columns = {}
        for name, e in out.items():
            dtype = infer_dtype(e)
            if self._kind in (JoinKind.LEFT, JoinKind.OUTER) and _references_side(e, self._right):
                dtype = dt.Optional_(dtype) if not dtype.is_optional() and dtype != dt.ANY else dtype
            if self._kind in (JoinKind.RIGHT, JoinKind.OUTER) and _references_side(e, self._left):
                dtype = dt.Optional_(dtype) if not dtype.is_optional() and dtype != dt.ANY else dtype
            columns[name] = sch.ColumnSchema(name, dtype)
        schema = sch.schema_from_columns(columns, "join")

        node = G.add_node(
            pg.JoinNode(
                inputs=[self._left, self._right],
                left_on=self._left_on,
                right_on=self._right_on,
                kind=self._kind,
                exprs=out,
                id_expr=id_expr,
            )
        )
        return Table(node, schema, name="join")

    def _side_is_left_safe(self, e: Any) -> bool:
        try:
            return self._side_of(expr.smart_coerce(e)) == "left"
        except ValueError:
            return False


class _JoinThis:
    """Resolution target for pw.this inside join select: prefers left, falls back right."""

    def __init__(self, jr: JoinResult):
        self._jr = jr

    def __getitem__(self, name: str) -> expr.ColumnReference:
        left, right = self._jr._left, self._jr._right
        in_left = name in left._schema.columns()
        in_right = name in right._schema.columns()
        if in_left and in_right:
            raise ValueError(f"column {name!r} exists on both join sides; use pw.left/pw.right")
        if in_left:
            return left[name]
        if in_right:
            return right[name]
        raise KeyError(name)

    @property
    def id(self) -> expr.ColumnReference:
        return self._jr._left.id


def _references_side(e: expr.ColumnExpression, table: Any) -> bool:
    return any(ref.table is table for ref in e._column_refs)
