"""``.str`` expression namespace (port of ``pathway_tpu/internals/expressions/string.py``,
the methods the slice uses)."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr


def _vec(fun: Callable, *arrays: np.ndarray) -> np.ndarray:
    from pathway_tpu_torch.engine.columnar import ERROR, Error
    from pathway_tpu_torch.engine.expression_evaluator import _tidy

    def wrapped(*vals: Any) -> Any:
        if any(isinstance(v, Error) for v in vals):
            return ERROR
        if vals and vals[0] is None:
            return None
        try:
            return fun(*vals)
        except Exception:
            return ERROR

    return _tidy(np.frompyfunc(wrapped, len(arrays), 1)(*arrays))


class StringNamespace:
    def __init__(self, e: expr.ColumnExpression):
        self._e = e

    def _method(self, name: str, fun: Callable, ret: dt.DType, *args: Any) -> expr.MethodCallExpression:
        return expr.MethodCallExpression(
            name, lambda *arrays: _vec(fun, *arrays), ret, self._e, *args
        )

    def len(self):
        return self._method("str.len", lambda s: len(s), dt.INT)

    def lower(self):
        return self._method("str.lower", lambda s: s.lower(), dt.STR)

    def startswith(self, prefix: Any):
        return self._method("str.startswith", lambda s, p: s.startswith(p), dt.BOOL, prefix)
