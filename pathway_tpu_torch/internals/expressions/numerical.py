"""``.num`` expression namespace (port of ``pathway_tpu/internals/expressions/numerical.py``)."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import expression as expr


class NumericalNamespace:
    def __init__(self, e: expr.ColumnExpression):
        self._e = e

    def _method(self, name: str, fun: Callable, ret: Any, *args: Any) -> expr.MethodCallExpression:
        return expr.MethodCallExpression(name, fun, ret, self._e, *args)

    def abs(self):
        return self._method(
            "num.abs",
            lambda a: np.abs(a) if a.dtype != object else np.frompyfunc(abs, 1, 1)(a),
            lambda dts: dts[0],
        )

    def round(self, decimals: Any = 0):
        def fun(a: np.ndarray, d: np.ndarray) -> np.ndarray:
            if a.dtype != object:
                return np.round(a.astype(np.float64), int(d[0]) if len(d) else 0)
            return np.frompyfunc(lambda x, dd: round(x, dd), 2, 1)(a, d)

        return self._method("num.round", fun, lambda dts: dts[0], decimals)

    def fill_na(self, default_value: Any):
        def fun(a: np.ndarray, d: np.ndarray) -> np.ndarray:
            from pathway_tpu_torch.engine.expression_evaluator import _tidy

            if a.dtype != object:
                if a.dtype.kind == "f":
                    return np.where(np.isnan(a), d.astype(np.float64), a)
                return a
            return _tidy(
                np.frompyfunc(
                    lambda x, dd: dd if x is None or (isinstance(x, float) and np.isnan(x)) else x,
                    2,
                    1,
                )(a, d)
            )

        return self._method("num.fill_na", fun, lambda dts: dts[0].strip_optional(), default_value)
