"""``.str`` expression namespace (port of ``pathway_tpu/internals/expressions/string.py``)."""

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

    def lower(self):
        return self._method("str.lower", lambda s: s.lower(), dt.STR)

    def upper(self):
        return self._method("str.upper", lambda s: s.upper(), dt.STR)

    def reversed(self):
        return self._method("str.reversed", lambda s: s[::-1], dt.STR)

    def strip(self, chars: Any = None):
        return self._method("str.strip", lambda s, c: s.strip(c), dt.STR, chars)

    def lstrip(self, chars: Any = None):
        return self._method("str.lstrip", lambda s, c: s.lstrip(c), dt.STR, chars)

    def rstrip(self, chars: Any = None):
        return self._method("str.rstrip", lambda s, c: s.rstrip(c), dt.STR, chars)

    def len(self):
        return self._method("str.len", lambda s: len(s), dt.INT)

    def count(self, sub: Any, start: Any = None, end: Any = None):
        return self._method(
            "str.count", lambda s, su, st, en: s.count(su, st, en), dt.INT, sub, start, end
        )

    def find(self, sub: Any, start: Any = None, end: Any = None):
        return self._method(
            "str.find", lambda s, su, st, en: s.find(su, st, en), dt.INT, sub, start, end
        )

    def rfind(self, sub: Any, start: Any = None, end: Any = None):
        return self._method(
            "str.rfind", lambda s, su, st, en: s.rfind(su, st, en), dt.INT, sub, start, end
        )

    def startswith(self, prefix: Any):
        return self._method("str.startswith", lambda s, p: s.startswith(p), dt.BOOL, prefix)

    def endswith(self, suffix: Any):
        return self._method("str.endswith", lambda s, p: s.endswith(p), dt.BOOL, suffix)

    def swapcase(self):
        return self._method("str.swapcase", lambda s: s.swapcase(), dt.STR)

    def title(self):
        return self._method("str.title", lambda s: s.title(), dt.STR)

    def replace(self, old: Any, new: Any, count: Any = -1):
        return self._method(
            "str.replace", lambda s, o, n, c: s.replace(o, n, c), dt.STR, old, new, count
        )

    def split(self, sep: Any = None, maxsplit: Any = -1):
        return self._method(
            "str.split",
            lambda s, sp, m: tuple(s.split(sp, m)),
            dt.List_(dt.STR),
            sep,
            maxsplit,
        )

    def slice(self, start: Any, end: Any):
        return self._method("str.slice", lambda s, a, b: s[a:b], dt.STR, start, end)

    def parse_int(self, optional: bool = False):
        ret = dt.Optional_(dt.INT) if optional else dt.INT
        if optional:
            def parse(s: Any) -> Any:
                try:
                    return int(s)
                except (ValueError, TypeError):
                    return None
        else:
            parse = lambda s: int(s)  # noqa: E731
        return self._method("str.parse_int", parse, ret)

    def parse_float(self, optional: bool = False):
        ret = dt.Optional_(dt.FLOAT) if optional else dt.FLOAT
        if optional:
            def parse(s: Any) -> Any:
                try:
                    return float(s)
                except (ValueError, TypeError):
                    return None
        else:
            parse = lambda s: float(s)  # noqa: E731
        return self._method("str.parse_float", parse, ret)

    def parse_bool(self, true_values: Any = None, false_values: Any = None, optional: bool = False):
        trues = {v.lower() for v in (true_values or ["on", "true", "yes", "1"])}
        falses = {v.lower() for v in (false_values or ["off", "false", "no", "0"])}

        def parse(s: Any) -> Any:
            sl = s.lower()
            if sl in trues:
                return True
            if sl in falses:
                return False
            if optional:
                return None
            raise ValueError(s)

        ret = dt.Optional_(dt.BOOL) if optional else dt.BOOL
        return self._method("str.parse_bool", parse, ret)
