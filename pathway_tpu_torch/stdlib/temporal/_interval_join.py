"""Interval joins (port of ``pathway_tpu/stdlib/temporal/_interval_join.py``).

Mechanism: right rows bucket once at ``floor(t/w)``; left rows expand (flatten) to every
bucket their interval ``[t+lo, t+hi]`` can touch, so each matching pair meets in exactly one
bucket — no dedup pass needed. Exact bound check applied as a post-filter.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Dict, List

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.joins import JoinKind
from pathway_tpu_torch.internals.table import Table, _name_of


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound: Any, upper_bound: Any) -> Interval:
    return Interval(lower_bound, upper_bound)


class IntervalJoinResult:
    def __init__(
        self,
        left: Table,
        right: Table,
        left_time: expr.ColumnExpression,
        right_time: expr.ColumnExpression,
        iv: Interval,
        on: tuple,
        kind: JoinKind,
        behavior: Any = None,
    ):
        self.left = left
        self.right = right
        self.left_time = left_time
        self.right_time = right_time
        self.interval = iv
        self.on = on
        self.kind = kind
        self.behavior = behavior

    def select(self, *args: Any, **kwargs: Any) -> Table:
        lo, hi = self.interval.lower_bound, self.interval.upper_bound
        width = hi - lo
        if _is_zero(width):
            width = _one_like(lo)

        def left_buckets(t: Any) -> tuple:
            start = _bucket_of(t + lo, width)
            end = _bucket_of(t + hi, width)
            out = []
            b = start
            while True:
                out.append(b)
                if b >= end:
                    break
                b += 1
            return tuple(out)

        def right_bucket(t: Any) -> int:
            return _bucket_of(t, width)

        from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
            apply_temporal_behavior,
        )

        lt = self.left.with_columns(
            _pw_t=self.left_time,
        )
        lt = apply_temporal_behavior(lt, self.behavior, "_pw_t")
        lt = lt.with_columns(
            _pw_buckets=expr.apply_with_type(left_buckets, dt.List_(dt.INT), lt._pw_t)
        )
        lflat = lt.flatten(lt._pw_buckets, origin_id="_pw_left_id")
        rt = self.right.with_columns(_pw_t=self.right_time)
        rt = apply_temporal_behavior(rt, self.behavior, "_pw_t")
        rt = rt.with_columns(
            _pw_bucket=expr.apply_with_type(right_bucket, int, rt._pw_t)
        )

        from pathway_tpu_torch.internals import thisclass

        conditions = [lflat._pw_buckets == rt._pw_bucket]
        for cond in self.on:
            cond = thisclass.substitute(
                cond, {thisclass.left: self.left, thisclass.right: self.right}
            )
            # rebind left refs onto lflat (columns copied by flatten), right onto rt
            cond = _rebind(cond, self.left, lflat, self.right, rt)
            conditions.append(cond)

        joined = lflat.join_inner(rt, *conditions)
        matched = joined.select(
            _pw_left_id=lflat._pw_left_id,
            _pw_right_id=rt.id,
            _pw_lt=lflat._pw_t,
            _pw_rt=rt._pw_t,
        )
        matched = matched.filter(
            (matched._pw_rt - matched._pw_lt >= lo) & (matched._pw_rt - matched._pw_lt <= hi)
        )

        out_exprs: Dict[str, Any] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = arg
        out_exprs.update(kwargs)

        lrows = self.left.ix(matched._pw_left_id)
        rrows = self.right.ix(matched._pw_right_id)
        resolved = {
            name: _rebind_sides(e, self.left, lrows, self.right, rrows)
            for name, e in out_exprs.items()
        }
        inner = matched.select(**resolved)

        if self.kind == JoinKind.INNER:
            return self._post_behavior(inner)
        # outer variants: pad unmatched sides
        parts = [inner]
        if self.kind in (JoinKind.LEFT, JoinKind.OUTER):
            matched_left = matched.groupby(matched._pw_left_id).reduce(
                _pw_id=matched._pw_left_id
            )
            unmatched_left = self._unmatched(self.left, matched_left)
            pad = {
                name: _rebind_sides(e, self.left, unmatched_left, self.right, None)
                for name, e in out_exprs.items()
            }
            parts.append(unmatched_left.select(**pad))
        if self.kind in (JoinKind.RIGHT, JoinKind.OUTER):
            matched_right = matched.groupby(matched._pw_right_id).reduce(
                _pw_id=matched._pw_right_id
            )
            unmatched_right = self._unmatched(self.right, matched_right)
            pad = {
                name: _rebind_sides(e, self.left, None, self.right, unmatched_right)
                for name, e in out_exprs.items()
            }
            parts.append(unmatched_right.select(**pad))
        return self._post_behavior(parts[0].concat_reindex(*parts[1:]))

    def _post_behavior(self, result: Table) -> Table:
        """keep_results=True forgetting must not remove already-delivered join results."""
        b = self.behavior
        if b is not None and b.cutoff is not None and b.keep_results:
            result = result._filter_out_results_of_forgetting()
        return result

    @staticmethod
    def _unmatched(table: Table, matched_ids: Table) -> Table:
        with_flag = table.having(matched_ids._pw_id)
        return table.difference(with_flag)


def _rebind(e: Any, old_left: Table, new_left: Table, old_right: Table, new_right: Table) -> Any:
    if isinstance(e, expr.ColumnReference):
        if e.table is old_left:
            return new_left[e.name]
        if e.table is old_right:
            return new_right[e.name]
        return e
    if isinstance(e, expr.ColumnExpression):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(clone, attr, _rebind(value, old_left, new_left, old_right, new_right))
            elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind(v, old_left, new_left, old_right, new_right)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def _rebind_sides(e: Any, old_left: Table, new_left: Any, old_right: Table, new_right: Any) -> Any:
    if isinstance(e, expr.ColumnReference):
        if e.table is old_left:
            return new_left[e.name] if new_left is not None else expr.ColumnConstExpression(None)
        if e.table is old_right:
            return new_right[e.name] if new_right is not None else expr.ColumnConstExpression(None)
        return e
    if isinstance(e, expr.ColumnExpression):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(clone, attr, _rebind_sides(value, old_left, new_left, old_right, new_right))
            elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind_sides(v, old_left, new_left, old_right, new_right)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def _bucket_of(t: Any, width: Any) -> int:
    if isinstance(t, datetime.datetime):
        epoch = datetime.datetime.min if t.tzinfo is None else datetime.datetime(
            1, 1, 1, tzinfo=datetime.timezone.utc
        )
        return int((t - epoch) // width)
    return int(t // width)


def _is_zero(width: Any) -> bool:
    if isinstance(width, datetime.timedelta):
        return width == datetime.timedelta(0)
    return width == 0


def _one_like(v: Any) -> Any:
    if isinstance(v, datetime.timedelta):
        return datetime.timedelta(seconds=1)
    if isinstance(v, float):
        return 1.0
    return 1


def interval_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    iv: Interval,
    *on: Any,
    behavior: Any = None,
    how: JoinKind = JoinKind.INNER,
) -> IntervalJoinResult:
    return IntervalJoinResult(
        self,
        other,
        self._resolve(self_time),
        other._resolve(other_time),
        iv,
        on,
        how,
        behavior=behavior,
    )


def interval_join_inner(self: Table, other: Table, self_time: Any, other_time: Any, iv: Interval, *on: Any, **kw: Any) -> IntervalJoinResult:
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinKind.INNER, **kw)


def interval_join_left(self: Table, other: Table, self_time: Any, other_time: Any, iv: Interval, *on: Any, **kw: Any) -> IntervalJoinResult:
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinKind.LEFT, **kw)


def interval_join_right(self: Table, other: Table, self_time: Any, other_time: Any, iv: Interval, *on: Any, **kw: Any) -> IntervalJoinResult:
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinKind.RIGHT, **kw)


def interval_join_outer(self: Table, other: Table, self_time: Any, other_time: Any, iv: Interval, *on: Any, **kw: Any) -> IntervalJoinResult:
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinKind.OUTER, **kw)
