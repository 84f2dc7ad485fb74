"""Static type inference over expressions (port of ``pathway_tpu/internals/type_interpreter.py``).

Infers output dtypes for schema propagation; runtime values are the source of
truth for dynamic columns.
"""

from __future__ import annotations

import operator

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr

_COMPARISONS = {operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge}
_BOOL_OPS = {operator.and_, operator.or_, operator.xor}


def infer_dtype(e: expr.ColumnExpression) -> dt.DType:
    if isinstance(e, expr.ColumnConstExpression):
        return dt.wrap(type(e._value)) if e._value is not None else dt.NONE
    if isinstance(e, expr.ColumnReference):
        if e.name == "id":
            return dt.POINTER
        col = e.table._schema.columns().get(e.name)
        return col.dtype if col is not None else dt.ANY
    if isinstance(e, expr.ColumnBinaryOpExpression):
        left = infer_dtype(e._left)
        right = infer_dtype(e._right)
        op = e._operator
        if op in _COMPARISONS:
            return dt.BOOL
        if op in _BOOL_OPS and left == dt.BOOL and right == dt.BOOL:
            return dt.BOOL
        l, r = left.strip_optional(), right.strip_optional()
        if op is operator.truediv:
            base: dt.DType = dt.FLOAT if {l, r} <= {dt.INT, dt.FLOAT} else dt.ANY
        elif {l, r} <= {dt.INT, dt.FLOAT, dt.BOOL}:
            base = dt.FLOAT if dt.FLOAT in (l, r) else dt.INT
        elif l == dt.STR and r == dt.STR and op is operator.add:
            base = dt.STR
        elif l == dt.STR and r == dt.INT and op is operator.mul:
            base = dt.STR
        elif l == r:
            base = l
        elif {l, r} == {dt.DATE_TIME_NAIVE, dt.DURATION}:
            base = dt.DATE_TIME_NAIVE
        elif {l, r} == {dt.DATE_TIME_UTC, dt.DURATION}:
            base = dt.DATE_TIME_UTC
        elif l == dt.DATE_TIME_NAIVE and r == dt.DATE_TIME_NAIVE:
            base = dt.DURATION
        else:
            base = dt.ANY
        if (left.is_optional() or right.is_optional()) and base not in (dt.ANY,):
            return dt.Optional_(base)
        return base
    if isinstance(e, expr.ColumnUnaryOpExpression):
        inner = infer_dtype(e._expr)
        if e._operator is operator.not_:
            return dt.BOOL
        return inner
    if isinstance(e, expr.IfElseExpression):
        return dt.types_lca(infer_dtype(e._then), infer_dtype(e._else))
    if isinstance(e, expr.CoalesceExpression):
        result = infer_dtype(e._args[0]).strip_optional() if e._args else dt.ANY
        for a in e._args[1:]:
            result = dt.types_lca(result, infer_dtype(a).strip_optional())
        last = infer_dtype(e._args[-1]) if e._args else dt.ANY
        if last.is_optional() or last == dt.NONE:
            return dt.Optional_(result) if result != dt.ANY else result
        return result
    if isinstance(e, expr.RequireExpression):
        inner = infer_dtype(e._val)
        return inner if inner.is_optional() else dt.Optional_(inner)
    if isinstance(e, (expr.IsNoneExpression, expr.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(e, expr.CastExpression):
        return e._target
    if isinstance(e, expr.ConvertExpression):
        return e._target if e._unwrap else dt.Optional_(e._target)
    if isinstance(e, expr.DeclareTypeExpression):
        return e._target
    if isinstance(e, expr.UnwrapExpression):
        return infer_dtype(e._expr).strip_optional()
    if isinstance(e, expr.FillErrorExpression):
        return dt.types_lca(infer_dtype(e._expr), infer_dtype(e._replacement))
    if isinstance(e, expr.ApplyExpression):
        return e._return_type
    if isinstance(e, expr.PointerExpression):
        return dt.Optional_(dt.POINTER) if e._optional else dt.POINTER
    if isinstance(e, expr.MakeTupleExpression):
        return dt.Tuple_(*(infer_dtype(a) for a in e._args))
    if isinstance(e, expr.GetExpression):
        obj = infer_dtype(e._object).strip_optional()
        if obj == dt.JSON:
            return dt.JSON if not e._check_if_exists else dt.Optional_(dt.JSON)
        if isinstance(obj, dt.List_):
            return obj.wrapped
        if isinstance(obj, dt.Tuple_):
            idx = e._index
            if isinstance(idx, expr.ColumnConstExpression) and isinstance(idx._value, int):
                if 0 <= idx._value < len(obj.args):
                    return obj.args[idx._value]
            return dt.ANY
        if isinstance(obj, dt.Array):
            return obj.wrapped if obj.n_dim == 1 else dt.ANY
        return dt.ANY
    if isinstance(e, expr.MethodCallExpression):
        rm = e._return_mapper
        if isinstance(rm, dt.DType):
            return rm
        try:
            return rm([infer_dtype(a) for a in e._args])
        except Exception:
            return dt.ANY
    if isinstance(e, expr.ReducerExpression):
        return e._reducer.return_dtype([infer_dtype(a) for a in e._args])
    return dt.ANY
