"""``.dt`` expression namespace (port of ``pathway_tpu/internals/expressions/date_time.py``).

Columns of DATE_TIME_NAIVE / DATE_TIME_UTC and DURATION are computed on as
numpy ``datetime64[ns]`` / ``timedelta64[ns]`` arrays. The reference reads
the calendar fields through pandas; the port computes them with numpy's
calendar units (and ``zoneinfo`` for time zones), since the GPU machine has
no pandas.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr

_NS_PER_S = 1_000_000_000


def _as_dt64(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[ns]")


def _ns(a: np.ndarray) -> np.ndarray:
    return _as_dt64(a).astype(np.int64)


def _duration_ns(d: Any) -> int:
    return int(np.timedelta64(d, "ns").astype(np.int64))


def _to_datetimes(a: np.ndarray) -> list:
    """Python ``datetime`` per cell (microsecond precision)."""
    return _as_dt64(a).astype("datetime64[us]").astype(object).tolist()


class DateTimeNamespace:
    def __init__(self, e: expr.ColumnExpression):
        self._e = e

    def _method(self, name: str, fun: Callable, ret: Any, *args: Any) -> expr.MethodCallExpression:
        return expr.MethodCallExpression(name, fun, ret, self._e, *args)

    def _int(self, name: str, fun: Callable[[np.ndarray], np.ndarray]) -> expr.MethodCallExpression:
        return self._method(
            f"dt.{name}", lambda a: np.asarray(fun(_as_dt64(a)), dtype=np.int64), dt.INT
        )

    def year(self):
        return self._int("year", lambda a: a.astype("datetime64[Y]").astype(np.int64) + 1970)

    def month(self):
        return self._int("month", lambda a: a.astype("datetime64[M]").astype(np.int64) % 12 + 1)

    def day(self):
        return self._int(
            "day",
            lambda a: (a.astype("datetime64[D]") - a.astype("datetime64[M]")).astype(np.int64) + 1,
        )

    def _in_day(self, name: str, unit_ns: int, modulo: int) -> expr.MethodCallExpression:
        def fun(a: np.ndarray) -> np.ndarray:
            since_midnight = (a - a.astype("datetime64[D]")).astype(np.int64)
            return since_midnight // unit_ns % modulo

        return self._int(name, fun)

    def hour(self):
        return self._in_day("hour", 3600 * _NS_PER_S, 24)

    def minute(self):
        return self._in_day("minute", 60 * _NS_PER_S, 60)

    def second(self):
        return self._in_day("second", _NS_PER_S, 60)

    def millisecond(self):
        return self._in_day("millisecond", 1_000_000, 1_000)

    def microsecond(self):
        return self._in_day("microsecond", 1_000, 1_000_000)

    def nanosecond(self):
        return self._in_day("nanosecond", 1, 1_000)

    def timestamp(self, unit: str = "ns"):
        divisors = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": _NS_PER_S}

        def fun(a: np.ndarray) -> np.ndarray:
            ns = _ns(a)
            return (ns / divisors[unit]).astype(np.float64) if unit != "ns" else ns

        return self._method("dt.timestamp", fun, dt.INT if unit == "ns" else dt.FLOAT)

    def strftime(self, fmt: Any):
        def fun(a: np.ndarray, f: np.ndarray) -> np.ndarray:
            out = np.empty(len(a), dtype=object)
            for i, (ts, fi) in enumerate(zip(_to_datetimes(a), f)):
                out[i] = ts.strftime(fi)
            return out

        return self._method("dt.strftime", fun, dt.STR, fmt)

    def strptime(self, fmt: Any, contains_timezone: bool = False):
        def fun(a: np.ndarray, f: np.ndarray) -> np.ndarray:
            out = np.empty(len(a), dtype="datetime64[ns]")
            for i, (s, fi) in enumerate(zip(a, f)):
                out[i] = np.datetime64(datetime.datetime.strptime(s, fi), "ns")
            return out

        return self._method(
            "dt.strptime", fun, dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE, fmt
        )

    def round(self, duration: Any):
        def fun(a: np.ndarray, d: np.ndarray) -> np.ndarray:
            step = _duration_ns(d[0])
            q, r = np.divmod(_ns(a), step)
            # ties to even, as pandas rounds
            up = (2 * r > step) | ((2 * r == step) & (q % 2 == 1))
            return ((q + up) * step).astype("datetime64[ns]")

        return self._method("dt.round", fun, dt.DATE_TIME_NAIVE, duration)

    def floor(self, duration: Any):
        def fun(a: np.ndarray, d: np.ndarray) -> np.ndarray:
            step = _duration_ns(d[0])
            return (_ns(a) // step * step).astype("datetime64[ns]")

        return self._method("dt.floor", fun, dt.DATE_TIME_NAIVE, duration)

    # duration accessors
    def nanoseconds(self):
        return self._dur("nanoseconds", 1)

    def microseconds(self):
        return self._dur("microseconds", 1_000)

    def milliseconds(self):
        return self._dur("milliseconds", 1_000_000)

    def seconds(self):
        return self._dur("seconds", _NS_PER_S)

    def minutes(self):
        return self._dur("minutes", 60 * _NS_PER_S)

    def hours(self):
        return self._dur("hours", 3600 * _NS_PER_S)

    def days(self):
        return self._dur("days", 86400 * _NS_PER_S)

    def weeks(self):
        return self._dur("weeks", 7 * 86400 * _NS_PER_S)

    def _dur(self, name: str, divisor: int) -> expr.MethodCallExpression:
        def fun(a: np.ndarray) -> np.ndarray:
            ns = a.astype("timedelta64[ns]").astype(np.int64)
            return ns // divisor

        return self._method(f"dt.{name}", fun, dt.INT)

    def to_naive_in_timezone(self, timezone: Any):
        def fun(a: np.ndarray, tz: np.ndarray) -> np.ndarray:
            from zoneinfo import ZoneInfo

            zone = ZoneInfo(tz[0])
            out = [
                ts.replace(tzinfo=datetime.timezone.utc).astimezone(zone).replace(tzinfo=None)
                for ts in _to_datetimes(a)
            ]
            return np.array(out, dtype="datetime64[ns]")

        return self._method("dt.to_naive_in_timezone", fun, dt.DATE_TIME_NAIVE, timezone)

    def to_utc(self, from_timezone: Any):
        def fun(a: np.ndarray, tz: np.ndarray) -> np.ndarray:
            from zoneinfo import ZoneInfo

            zone = ZoneInfo(tz[0])
            out = [
                ts.replace(tzinfo=zone).astimezone(datetime.timezone.utc).replace(tzinfo=None)
                for ts in _to_datetimes(a)
            ]
            return np.array(out, dtype="datetime64[ns]")

        return self._method("dt.to_utc", fun, dt.DATE_TIME_UTC, from_timezone)
