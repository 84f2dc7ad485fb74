"""UDF system (port of ``pathway_tpu/internals/udfs/__init__.py``, synchronous UDFs).

``pw.udf`` and the ``UDF`` base class that parsers, splitters and embedders
derive from. The engine batches UDF calls column-wise; a UDF whose
``deterministic`` flag is False has its value memoized per row and replayed
on the row's retraction. Async executors, retries and caches are not
ported.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr


class UDF:
    """Base class for user-defined functions; also produced by ``@pw.udf``.

    Subclasses set ``self.func`` (or define ``__wrapped__``)."""

    def __init__(
        self,
        *,
        return_type: Any = None,
        propagate_none: bool = False,
        deterministic: bool = False,
        max_batch_size: int | None = None,
    ):
        self.return_type = return_type
        self.propagate_none = propagate_none
        self.deterministic = deterministic
        self.max_batch_size = max_batch_size
        self.func: Callable | None = getattr(self, "__wrapped__", None)

    def _resolved_return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        fun = self.func
        if fun is not None:
            try:
                import typing

                hints = typing.get_type_hints(fun)
            except Exception:
                hints = getattr(fun, "__annotations__", {})
            if hints and "return" in hints:
                return hints["return"]
        return Any

    def _wrapped_fun(self) -> Callable:
        fun = self.func
        assert fun is not None, "UDF must define __wrapped__"
        if inspect.iscoroutinefunction(fun):
            raise NotImplementedError("async UDFs are not ported; use a synchronous function")
        return fun

    def __call__(self, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
        return expr.ApplyExpression(
            self._wrapped_fun(),
            self._resolved_return_type(),
            self.propagate_none,
            self.deterministic,
            args,
            kwargs,
            self.max_batch_size,
        )


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    propagate_none: bool = False,
    deterministic: bool = False,
    max_batch_size: int | None = None,
) -> Any:
    """Decorator turning a function into a column UDF (``pw.udf``)."""

    def wrapper(f: Callable) -> UDF:
        instance = UDF(
            return_type=return_type,
            propagate_none=propagate_none,
            deterministic=deterministic,
            max_batch_size=max_batch_size,
        )
        instance.func = f
        functools.update_wrapper(instance, f)  # type: ignore[arg-type]
        return instance

    if fun is not None:
        return wrapper(fun)
    return wrapper
