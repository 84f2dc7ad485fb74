"""Windows: tumbling / sliding / session / intervals_over.

Port of ``pathway_tpu/stdlib/temporal/_window.py``. Windows desugar onto the core
engine: assign each row its window(s) (≤1 for tumbling, k for sliding via flatten, computed
per-instance for session), then groupby (window, instance). ``_pw_window_start`` /
``_pw_window_end`` / ``_pw_instance`` columns match the reference's naming.
"""

from __future__ import annotations

import datetime
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table, _name_of
from pathway_tpu_torch.internals import thisclass


def _time_dtype(time_expr: expr.ColumnExpression) -> dt.DType:
    """The window-bound dtype: same as the time column's (window starts/ends
    are arithmetic on time values). Typing these keeps ``_pw_window_start``/
    ``_pw_window_end`` in typed arrays downstream — the engine's columnar fast
    paths only fire when dtypes survive windowing."""
    from pathway_tpu_torch.internals.type_interpreter import infer_dtype

    return infer_dtype(time_expr).strip_optional()


class Window(ABC):
    @abstractmethod
    def assign(self, table: Table, time_expr: expr.ColumnExpression) -> Table:
        """Return table extended with _pw_window_start/_pw_window_end (maybe flattened)."""


class TumblingWindow(Window):
    def __init__(self, duration: Any, origin: Any = None, offset: Any = None):
        self.duration = duration
        self.origin = origin if origin is not None else offset

    def assign(self, table: Table, time_expr: expr.ColumnExpression) -> Table:
        duration = self.duration
        origin = self.origin

        def window_start(t: Any) -> Any:
            base = origin if origin is not None else (
                datetime.datetime.min if isinstance(t, datetime.datetime) else 0
            )
            k = (t - base) // duration
            return base + k * duration

        start_e = expr.apply_with_type(window_start, _time_dtype(time_expr), time_expr)
        with_cols = table.with_columns(
            _pw_window_start=start_e,
        )
        return with_cols.with_columns(
            _pw_window_end=with_cols._pw_window_start + duration,
        )


class SlidingWindow(Window):
    def __init__(self, hop: Any, duration: Any = None, ratio: int | None = None, origin: Any = None, offset: Any = None):
        self.hop = hop
        self.duration = duration if duration is not None else hop * (ratio or 1)
        self.origin = origin if origin is not None else offset

    def assign(self, table: Table, time_expr: expr.ColumnExpression) -> Table:
        hop, duration, origin = self.hop, self.duration, self.origin

        def windows_for(t: Any) -> tuple:
            base = origin if origin is not None else (
                datetime.datetime.min if isinstance(t, datetime.datetime) else 0
            )
            # window starts s with s <= t < s + duration and s ≡ base (mod hop)
            out = []
            k = (t - base) // hop
            s = base + k * hop
            while s + duration > t:
                if s <= t:
                    out.append(s)
                s -= hop
            return tuple(sorted(out))

        starts = expr.apply_with_type(
            windows_for, dt.List_(_time_dtype(time_expr)), time_expr
        )
        with_starts = table.with_columns(_pw_window_start=starts)
        flat = with_starts.flatten(with_starts._pw_window_start)
        return flat.with_columns(_pw_window_end=flat._pw_window_start + duration)


class SessionWindow(Window):
    def __init__(self, predicate: Callable | None = None, max_gap: Any = None):
        self.predicate = predicate
        self.max_gap = max_gap

    def assign(self, table: Table, time_expr: expr.ColumnExpression) -> Table:
        # handled specially in windowby (needs per-instance grouping of all rows)
        raise NotImplementedError


class IntervalsOverWindow(Window):
    def __init__(self, at: Any, lower_bound: Any, upper_bound: Any, is_outer: bool = True):
        self.at = at
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.is_outer = is_outer

    def assign(self, table: Table, time_expr: expr.ColumnExpression) -> Table:
        raise NotImplementedError


def tumbling(duration: Any, origin: Any = None, offset: Any = None) -> TumblingWindow:
    return TumblingWindow(duration, origin, offset)


def sliding(hop: Any, duration: Any = None, ratio: int | None = None, origin: Any = None, offset: Any = None) -> SlidingWindow:
    return SlidingWindow(hop, duration, ratio, origin, offset)


def session(*, predicate: Callable | None = None, max_gap: Any = None) -> SessionWindow:
    return SessionWindow(predicate, max_gap)


def intervals_over(*, at: Any, lower_bound: Any, upper_bound: Any, is_outer: bool = True) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowedTable:
    """Result of ``windowby``; call ``.reduce(...)``."""

    def __init__(
        self,
        assigned: Table,
        instance_name: str | None,
        window: Window,
        shard_cols: Dict[str, str],
        behavior: Any = None,
    ):
        self.assigned = assigned
        self.instance_name = instance_name
        self.window = window
        self.shard_cols = shard_cols  # user column name -> assigned column name
        self.behavior = behavior

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        t = self.assigned
        grouping = [t._pw_window_start, t._pw_window_end]
        if self.instance_name:
            grouping.append(t[self.instance_name])
        grouped = t.groupby(
            *grouping,
        )
        out_exprs: Dict[str, Any] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = arg
        out_exprs.update(kwargs)
        resolved = {}
        for name, e in out_exprs.items():
            resolved[name] = _rebind_window_refs(e, t, self.instance_name)
        result = grouped.reduce(**resolved)
        from pathway_tpu_torch.stdlib.temporal.temporal_behavior import CommonBehavior

        if (
            isinstance(self.behavior, CommonBehavior)
            and self.behavior.cutoff is not None
            and self.behavior.keep_results
        ):
            # forgetting retractions (neu times) must not remove delivered window results
            result = result._filter_out_results_of_forgetting()
        if isinstance(self.window, IntervalsOverWindow) and self.window.is_outer:
            result = self._add_empty_windows(result, resolved)
        return result

    def _add_empty_windows(self, result: Table, resolved: Dict[str, Any]) -> Table:
        """Outer intervals_over: every ``at`` point yields a window even with no rows;
        reducer columns are None for empty windows."""
        if self.instance_name:
            return result  # instance-grouped outer windows not yet supported
        at_col = self.window.at  # type: ignore[attr-defined]
        ats = at_col.table.groupby(at_col).reduce(_pw_at=at_col)
        win = ats.select(_pw_window_start=ats._pw_at, _pw_window_end=ats._pw_at)
        win = win.with_id(win.pointer_from(win._pw_window_start, win._pw_window_end))
        null_exprs: Dict[str, Any] = {}
        for name, e in resolved.items():
            null_exprs[name] = _empty_window_value(e, win)
        empty_rows = win.select(**null_exprs)
        return empty_rows.update_rows(result)


def _empty_window_value(e: Any, win: Table) -> Any:
    """Value of a reduce output expression over an empty window: window-bound refs map to
    the ``at`` point's window columns, anything involving data reducers becomes None."""
    if isinstance(e, expr.ColumnReference):
        if e.name in ("_pw_window_start", "_pw_window_end"):
            return win[e.name]
        return expr.ColumnConstExpression(None)
    if isinstance(e, expr.MakeTupleExpression):
        parts = [_empty_window_value(v, win) for v in e._args]
        if all(
            isinstance(p, (expr.ColumnReference, expr.ColumnConstExpression)) for p in parts
        ):
            return expr.make_tuple(*parts)
    return expr.ColumnConstExpression(None)


def _rebind_window_refs(e: Any, t: Table, instance_name: str | None) -> Any:
    """Map pw.this refs onto the assigned table, incl. _pw_window* virtual columns."""
    if isinstance(e, thisclass.ThisColumnReference):
        name = e.name
        if name == "_pw_window":
            return expr.make_tuple(t._pw_window_start, t._pw_window_end)
        if name == "_pw_instance":
            return t[instance_name] if instance_name else expr.ColumnConstExpression(None)
        return t[name]
    if isinstance(e, expr.ColumnReference):
        if e.name in ("_pw_window_start", "_pw_window_end") and e.table is not t:
            return t[e.name]
        return e
    if isinstance(e, expr.ColumnExpression):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(clone, attr, _rebind_window_refs(value, t, instance_name))
            elif isinstance(value, tuple) and any(
                isinstance(v, expr.ColumnExpression) for v in value
            ):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind_window_refs(v, t, instance_name)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def windowby(
    table: Table,
    time_expr: Any,
    *,
    window: Window,
    behavior: Any = None,
    instance: Any = None,
    **kwargs: Any,
) -> WindowedTable:
    time_e = table._resolve(time_expr)
    instance_name = None
    if instance is not None:
        instance_name = _name_of(instance)

    if isinstance(window, SessionWindow):
        assigned = _assign_sessions(table, time_e, window, instance_name)
    elif isinstance(window, IntervalsOverWindow):
        assigned = _assign_intervals_over(table, time_e, window, instance_name)
    else:
        with_time = table.with_columns(_pw_time=time_e)
        assigned = window.assign(with_time, with_time._pw_time)
    behavior = _canonical_behavior(behavior, window)
    if behavior is not None:
        assigned = _apply_behavior(assigned, behavior)
    return WindowedTable(assigned, instance_name, window, {}, behavior=behavior)


def _assign_sessions(
    table: Table, time_e: expr.ColumnExpression, window: SessionWindow, instance_name: str | None
) -> Table:
    """Compute per-instance session membership via a grouped sorted-tuple + row-wise lookup."""
    max_gap = window.max_gap
    predicate = window.predicate

    t = table.with_columns(_pw_time=time_e)
    if instance_name:
        # grouped-by-instance id is pointer_from(instance), so rows can ix into it
        agg = t.groupby(t[instance_name]).reduce(
            t[instance_name], _pw_times=reducers.sorted_tuple(t._pw_time)
        )
        lookup = t.select(
            _pw_times=agg.ix(t.pointer_from(t[instance_name]))._pw_times
        )
        times_col = lookup._pw_times
    else:
        agg = t.groupby().reduce(_pw_times=reducers.sorted_tuple(t._pw_time))
        lookup = t.select(_pw_times=agg.ix(t.pointer_from())._pw_times)
        times_col = lookup._pw_times

    def session_bounds(mytime: Any, times: tuple) -> tuple:
        # split sorted times into sessions by gap / predicate; find mine
        sessions: list[list] = []
        for v in times:
            if not sessions:
                sessions.append([v])
                continue
            prev = sessions[-1][-1]
            joined = (
                predicate(prev, v)
                if predicate is not None
                else (v - prev) <= max_gap
            )
            if joined:
                sessions[-1].append(v)
            else:
                sessions.append([v])
        for s in sessions:
            if s[0] <= mytime <= s[-1] and mytime in s:
                return (s[0], s[-1])
        return (mytime, mytime)

    td = _time_dtype(time_e)
    bounds = expr.apply_with_type(
        session_bounds, dt.Tuple_(td, td), t._pw_time, times_col
    )
    with_bounds = t.with_columns(_pw_session=bounds)
    return with_bounds.with_columns(
        _pw_window_start=with_bounds._pw_session[0],
        _pw_window_end=with_bounds._pw_session[1],
    ).without("_pw_session")


def _assign_intervals_over(
    table: Table, time_e: expr.ColumnExpression, window: IntervalsOverWindow, instance_name: str | None
) -> Table:
    """Each ``at`` point defines a window [at+lower, at+upper]; rows join all containing."""
    at_column = window.at
    at_table = at_column.table
    lower, upper = window.lower_bound, window.upper_bound
    ats = at_table.groupby(at_column).reduce(_pw_at=at_column)
    collected = ats.groupby().reduce(_pw_all_ats=reducers.sorted_tuple(ats._pw_at))
    t = table.with_columns(_pw_time=time_e)
    with_ats = t.select(
        _pw_ats_tuple=collected.ix(t.pointer_from())._pw_all_ats,
    )

    def matching_ats(mytime: Any, all_ats: tuple) -> tuple:
        return tuple(a for a in all_ats if a + lower <= mytime <= a + upper)

    matched = t.with_columns(
        _pw_window_start=expr.apply_with_type(
            matching_ats,
            dt.List_(_time_dtype(time_e)),
            t._pw_time,
            with_ats._pw_ats_tuple,
        )
    )
    flat = matched.flatten(matched._pw_window_start)
    return flat.with_columns(
        _pw_window_end=flat._pw_window_start,
    )


def _canonical_behavior(behavior: Any, window: Window) -> Any:
    """ExactlyOnceBehavior desugars to common_behavior(duration+shift, shift, True) as in
    the reference."""
    from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
        CommonBehavior,
        ExactlyOnceBehavior,
        common_behavior,
    )

    if not isinstance(behavior, ExactlyOnceBehavior):
        return behavior
    duration = getattr(window, "duration", None)
    if duration is None:
        raise ValueError("exactly_once_behavior requires a tumbling/sliding window")
    shift = behavior.shift
    if shift is None:
        shift = (
            datetime.timedelta(0) if isinstance(duration, datetime.timedelta) else 0
        )
    return common_behavior(duration + shift, shift, True)


def _apply_behavior(assigned: Table, behavior: Any) -> Table:
    """Wire behavior onto the assigned rows via the engine's time-threshold operators,
    in the reference's order: freeze late rows past the cutoff,
    buffer emission until window_start+delay, forget rows past the cutoff."""
    from pathway_tpu_torch.stdlib.temporal.temporal_behavior import CommonBehavior

    if not isinstance(behavior, CommonBehavior):
        raise ValueError(f"unsupported window behavior: {behavior!r}")
    t = assigned
    if behavior.cutoff is not None:
        t = t._freeze(t._pw_window_end + behavior.cutoff, t._pw_time)
    if behavior.delay is not None:
        t = t._buffer(t._pw_window_start + behavior.delay, t._pw_time)
    if behavior.cutoff is not None:
        t = t._forget(
            t._pw_window_end + behavior.cutoff, t._pw_time, behavior.keep_results
        )
    return t
