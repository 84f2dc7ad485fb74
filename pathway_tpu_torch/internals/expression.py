"""Lazy column-expression AST (port of ``pathway_tpu/internals/expression.py``).

Expressions are built by operator overloading on column references,
type-inferred statically, and evaluated by the engine's host interpreter
(``engine/expression_evaluator.py``) over whole column batches.
"""

from __future__ import annotations

import operator
from abc import ABC
from typing import TYPE_CHECKING, Any, Callable, Mapping, Tuple

from pathway_tpu_torch.internals import dtype as dt

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ColumnExpression(ABC):
    """Base class of all column expressions."""

    _dtype: dt.DType | None = None

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.add, self, other)

    def __radd__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.add, other, self)

    def __sub__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.sub, self, other)

    def __rsub__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.sub, other, self)

    def __mul__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.mul, self, other)

    def __rmul__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.mul, other, self)

    def __truediv__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.truediv, self, other)

    def __rtruediv__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.truediv, other, self)

    def __floordiv__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.floordiv, other, self)

    def __mod__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.mod, self, other)

    def __rmod__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.mod, other, self)

    def __pow__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.pow, self, other)

    def __rpow__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.pow, other, self)

    def __matmul__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.matmul, other, self)

    def __neg__(self) -> "ColumnUnaryOpExpression":
        return ColumnUnaryOpExpression(operator.neg, self)

    # -- comparisons --------------------------------------------------------
    def __eq__(self, other: Any) -> "ColumnBinaryOpExpression":  # type: ignore[override]
        return ColumnBinaryOpExpression(operator.eq, self, other)

    def __ne__(self, other: Any) -> "ColumnBinaryOpExpression":  # type: ignore[override]
        return ColumnBinaryOpExpression(operator.ne, self, other)

    def __lt__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.lt, self, other)

    def __le__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.le, self, other)

    def __gt__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.gt, self, other)

    def __ge__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.ge, self, other)

    # -- boolean ------------------------------------------------------------
    def __and__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.and_, self, other)

    def __rand__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.and_, other, self)

    def __or__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.or_, self, other)

    def __ror__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.or_, other, self)

    def __xor__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.xor, self, other)

    def __rxor__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.xor, other, self)

    def __lshift__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.lshift, self, other)

    def __rlshift__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.lshift, other, self)

    def __rshift__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.rshift, self, other)

    def __rrshift__(self, other: Any) -> "ColumnBinaryOpExpression":
        return ColumnBinaryOpExpression(operator.rshift, other, self)

    def __invert__(self) -> "ColumnUnaryOpExpression":
        return ColumnUnaryOpExpression(operator.not_, self)

    def __abs__(self) -> "ColumnUnaryOpExpression":
        return ColumnUnaryOpExpression(operator.abs, self)

    def __bool__(self) -> bool:
        raise RuntimeError(
            "ColumnExpression is lazy and cannot be used as a bool; "
            "use & | ~ instead of and/or/not"
        )

    def __hash__(self) -> int:
        return id(self)

    # -- access -------------------------------------------------------------
    def __getitem__(self, item: Any) -> "GetExpression":
        return GetExpression(self, item, check_if_exists=False)

    def get(self, item: Any, default: Any = None) -> "GetExpression":
        return GetExpression(self, item, default=default, check_if_exists=True)

    # -- type casts ---------------------------------------------------------
    def is_none(self) -> "IsNoneExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "IsNotNoneExpression":
        return IsNotNoneExpression(self)

    def as_int(self, unwrap: bool = False) -> "ConvertExpression":
        return ConvertExpression(dt.INT, self, unwrap=unwrap)

    def as_float(self, unwrap: bool = False) -> "ConvertExpression":
        return ConvertExpression(dt.FLOAT, self, unwrap=unwrap)

    def as_str(self, unwrap: bool = False) -> "ConvertExpression":
        return ConvertExpression(dt.STR, self, unwrap=unwrap)

    def as_bool(self, unwrap: bool = False) -> "ConvertExpression":
        return ConvertExpression(dt.BOOL, self, unwrap=unwrap)

    def to_string(self) -> "ConvertExpression":
        return ConvertExpression(dt.STR, self)

    # -- namespaces ---------------------------------------------------------
    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    def _deps(self) -> Tuple["ColumnExpression", ...]:
        return ()

    @property
    def _column_refs(self) -> list["ColumnReference"]:
        out: list[ColumnReference] = []
        stack: list[ColumnExpression] = [self]
        while stack:
            node = stack.pop()
            if isinstance(node, ColumnReference):
                out.append(node)
            stack.extend(node._deps())
        return out


ColumnExpressionOrValue = Any


def smart_coerce(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ColumnConstExpression(value)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def __repr__(self) -> str:
        return repr(self._value)


class ColumnReference(ColumnExpression):
    """``table.column_name`` / ``table['column_name']``."""

    def __init__(self, table: "Table", name: str):
        self._table = table
        self._name = name

    @property
    def table(self) -> "Table":
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return f"<{self._table._name}>.{self._name}"

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(f"column {self._name!r} is not callable")


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, op: Callable, left: Any, right: Any):
        self._operator = op
        self._left = smart_coerce(left)
        self._right = smart_coerce(right)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._left, self._right)

    def __repr__(self) -> str:
        return f"({self._left!r} {self._operator.__name__} {self._right!r})"


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, op: Callable, expr: Any):
        self._operator = op
        self._expr = smart_coerce(expr)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class ReducerExpression(ColumnExpression):
    """An aggregation over a grouped table column (reference ``ReducerExpression``)."""

    def __init__(self, reducer: Any, *args: Any, **kwargs: Any):
        self._reducer = reducer
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return self._args

    def __repr__(self) -> str:
        return f"pw.reducers.{self._reducer.name}({', '.join(map(repr, self._args))})"


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        propagate_none: bool,
        deterministic: bool,
        args: tuple,
        kwargs: Mapping[str, Any],
        max_batch_size: int | None = None,
    ):
        self._fun = fun
        self._return_type = dt.wrap(return_type)
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = {k: smart_coerce(v) for k, v in kwargs.items()}
        self._max_batch_size = max_batch_size

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return self._args + tuple(self._kwargs.values())


class BatchApplyExpression(ApplyExpression):
    """fun receives whole columns (lists) and returns a list: one call per
    commit batch (at most ``max_batch_size`` rows), so a device UDF such as
    the embedder sees the whole batch at once."""


class AsyncApplyExpression(ApplyExpression):
    """fun is a coroutine function: a commit's rows are awaited together
    (``asyncio.gather``)."""


class FullyAsyncApplyExpression(ApplyExpression):
    autocommit_duration_ms: int | None = 100


class CastExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr: Any):
        self._target = target
        self._expr = smart_coerce(expr)
        self._dtype = target

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr: Any, default: Any = None, unwrap: bool = False):
        self._target = target
        self._expr = smart_coerce(expr)
        self._default = smart_coerce(default)
        self._unwrap = unwrap

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr, self._default)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, target: Any, expr: Any):
        self._target = dt.wrap(target)
        self._expr = smart_coerce(expr)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(smart_coerce(a) for a in args)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return self._args


class RequireExpression(ColumnExpression):
    def __init__(self, val: Any, *args: Any):
        self._val = smart_coerce(val)
        self._args = tuple(smart_coerce(a) for a in args)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._val,) + self._args


class IfElseExpression(ColumnExpression):
    def __init__(self, _if: Any, _then: Any, _else: Any):
        self._if = smart_coerce(_if)
        self._then = smart_coerce(_then)
        self._else = smart_coerce(_else)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._if, self._then, self._else)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = smart_coerce(expr)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = smart_coerce(expr)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class PointerExpression(ColumnExpression):
    """``table.pointer_from(...)`` — key derivation expression."""

    def __init__(self, table: "Table", *args: Any, optional: bool = False, instance: Any = None):
        self._table = table
        self._args = tuple(smart_coerce(a) for a in args)
        self._optional = optional
        self._instance = smart_coerce(instance) if instance is not None else None

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        extra = (self._instance,) if self._instance is not None else ()
        return self._args + extra


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(smart_coerce(a) for a in args)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj: Any, index: Any, default: Any = None, check_if_exists: bool = True):
        self._object = smart_coerce(obj)
        self._index = smart_coerce(index)
        self._default = smart_coerce(default)
        self._check_if_exists = check_if_exists

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._object, self._index, self._default)


class MethodCallExpression(ColumnExpression):
    """A ``.dt`` / ``.str`` / ``.num`` namespace method call, dispatched by dtype."""

    def __init__(self, name: str, fun: Callable, return_mapper: Callable | Any, *args: Any):
        self._method_name = name
        self._fun = fun  # python callable over scalar/ndarray columns
        self._return_mapper = return_mapper  # DType or fn(arg dtypes)->DType
        self._args = tuple(smart_coerce(a) for a in args)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return self._args


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = smart_coerce(expr)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: Any, replacement: Any):
        self._expr = smart_coerce(expr)
        self._replacement = smart_coerce(replacement)

    def _deps(self) -> Tuple[ColumnExpression, ...]:
        return (self._expr, self._replacement)


# -- public helpers (exported as pw.if_else etc.) ---------------------------


def if_else(_if: Any, _then: Any, _else: Any) -> IfElseExpression:
    return IfElseExpression(_if, _then, _else)


def coalesce(*args: Any) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val: Any, *args: Any) -> RequireExpression:
    return RequireExpression(val, *args)


def cast(target: Any, expr: Any) -> CastExpression:
    return CastExpression(dt.wrap(target), expr)


def declare_type(target: Any, expr: Any) -> DeclareTypeExpression:
    return DeclareTypeExpression(target, expr)


def unwrap(expr: Any) -> UnwrapExpression:
    return UnwrapExpression(expr)


def fill_error(expr: Any, replacement: Any) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def make_tuple(*args: Any) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def apply(fun: Callable, *args: Any, **kwargs: Any) -> ApplyExpression:
    import typing

    hints = typing.get_type_hints(fun) if callable(fun) and hasattr(fun, "__annotations__") else {}
    return_type = hints.get("return", Any)
    return ApplyExpression(fun, return_type, False, True, args, kwargs)


def apply_with_type(fun: Callable, ret_type: Any, *args: Any, **kwargs: Any) -> ApplyExpression:
    return ApplyExpression(fun, ret_type, False, True, args, kwargs)


def apply_async(fun: Callable, *args: Any, **kwargs: Any) -> AsyncApplyExpression:
    import typing

    hints = typing.get_type_hints(fun) if callable(fun) and hasattr(fun, "__annotations__") else {}
    return_type = hints.get("return", Any)
    return AsyncApplyExpression(fun, return_type, False, True, args, kwargs)
