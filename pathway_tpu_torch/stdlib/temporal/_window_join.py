"""Window joins (port of ``pathway_tpu/stdlib/temporal/_window_join.py``).

A window join is an interval/equality join on window membership: both sides assign windows,
then join on (window, *on).
"""

from __future__ import annotations

from typing import Any, Dict

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.joins import JoinKind
from pathway_tpu_torch.internals.table import Table, _name_of
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.stdlib.temporal._window import Window


class WindowJoinResult:
    def __init__(
        self,
        left: Table,
        right: Table,
        left_time: expr.ColumnExpression,
        right_time: expr.ColumnExpression,
        window: Window,
        on: tuple,
        kind: JoinKind,
    ):
        self.left = left
        self.right = right
        self.left_time = left_time
        self.right_time = right_time
        self.window = window
        self.on = on
        self.kind = kind

    def select(self, *args: Any, **kwargs: Any) -> Table:
        from pathway_tpu_torch.stdlib.temporal._window import SessionWindow

        if isinstance(self.window, SessionWindow):
            return self._select_session(*args, **kwargs)
        lt = self.window.assign(self.left, self.left_time)
        rt = self.window.assign(self.right, self.right_time)

        conditions = [
            lt._pw_window_start == rt._pw_window_start,
            lt._pw_window_end == rt._pw_window_end,
        ]
        for cond in self.on:
            cond = thisclass.substitute(
                cond, {thisclass.left: self.left, thisclass.right: self.right}
            )
            conditions.append(_rebind2(cond, self.left, lt, self.right, rt))

        joined = self._join(lt, rt, conditions)

        out_exprs: Dict[str, Any] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = arg
        out_exprs.update(kwargs)
        resolved = {}
        for name, e in out_exprs.items():
            # window virtual columns resolve before this/left/right substitution
            # (pw.this._pw_window_start has no table to substitute onto); outer
            # modes take whichever side is present
            if isinstance(e, thisclass.ThisColumnReference) and e.name in (
                "_pw_window",
                "_pw_window_start",
                "_pw_window_end",
            ):
                if e.name == "_pw_window":
                    from pathway_tpu_torch.internals import expression as e_mod

                    e2 = e_mod.make_tuple(
                        expr.coalesce(lt._pw_window_start, rt._pw_window_start),
                        expr.coalesce(lt._pw_window_end, rt._pw_window_end),
                    )
                else:
                    e2 = expr.coalesce(lt[e.name], rt[e.name])
                resolved[name] = e2
                continue
            e = thisclass.substitute(
                e, {thisclass.left: self.left, thisclass.right: self.right}
            )
            resolved[name] = _rebind2(e, self.left, lt, self.right, rt)
        return joined.select(**resolved)

    def _join(self, lt: Table, rt: Table, conditions: list) -> Any:
        return lt.join(rt, *conditions, how=self.kind)

    def _select_session(self, *args: Any, **kwargs: Any) -> Table:
        """Session windows form over the CONCATENATION of both sides (per join key):
        a left and a right record sharing one session join. Mechanism: a slim union table (time, key,
        side, origin id) is session-assigned per key; sides re-split and join on
        (session, key); original columns resolve through ``ix`` on the origin ids
        so outer modes pad naturally."""
        import operator

        from pathway_tpu_torch.internals import expression as e_mod
        from pathway_tpu_torch.stdlib.temporal._window import _assign_sessions

        left, right = self.left, self.right
        left_on: list = []
        right_on: list = []
        for cond in self.on:
            cond = thisclass.substitute(
                cond, {thisclass.left: left, thisclass.right: right}
            )
            assert (
                isinstance(cond, expr.ColumnBinaryOpExpression)
                and cond._operator is operator.eq
            ), "session window_join conditions must be equalities"
            a, b = cond._left, cond._right
            if any(r.table is left for r in a._column_refs):
                left_on.append(a)
                right_on.append(b)
            else:
                left_on.append(b)
                right_on.append(a)

        def slim(table: Table, time_e: Any, keys: list, side: bool) -> Table:
            return table.select(
                _pw_t=time_e,
                _pw_orig=table.id,
                _pw_side=e_mod.ColumnConstExpression(side),
                _pw_inst=e_mod.make_tuple(*keys) if keys else e_mod.ColumnConstExpression(0),
            )

        lt0 = slim(left, self.left_time, left_on, False)
        rt0 = slim(right, self.right_time, right_on, True)
        union = lt0.concat_reindex(rt0)
        assigned = _assign_sessions(union, union._pw_t, self.window, "_pw_inst")
        ls = assigned.filter(~assigned._pw_side)
        rs = assigned.filter(assigned._pw_side)
        joined = ls.join(
            rs,
            ls._pw_window_start == rs._pw_window_start,
            ls._pw_window_end == rs._pw_window_end,
            ls._pw_inst == rs._pw_inst,
            how=self.kind,
        )
        m = joined.select(
            _pw_l=ls._pw_orig,
            _pw_r=rs._pw_orig,
            _pw_ws=expr.coalesce(ls._pw_window_start, rs._pw_window_start),
            _pw_we=expr.coalesce(ls._pw_window_end, rs._pw_window_end),
        )
        lrows = left.ix(m._pw_l, optional=True)
        rrows = right.ix(m._pw_r, optional=True)

        out_exprs: Dict[str, Any] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = arg
        out_exprs.update(kwargs)
        resolved = {}
        for name, e in out_exprs.items():
            e = thisclass.substitute(
                e, {thisclass.left: left, thisclass.right: right}
            )
            if isinstance(e, expr.ColumnReference) and e.name in (
                "_pw_window",
                "_pw_window_start",
                "_pw_window_end",
            ):
                resolved[name] = (
                    e_mod.make_tuple(m._pw_ws, m._pw_we) if e.name == "_pw_window"
                    else (m._pw_ws if e.name == "_pw_window_start" else m._pw_we)
                )
                continue
            resolved[name] = _rebind2(e, left, lrows, right, rrows)
        return m.select(**resolved)


def _rebind2(e: Any, old_left: Table, new_left: Table, old_right: Table, new_right: Table) -> Any:
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
                setattr(clone, attr, _rebind2(value, old_left, new_left, old_right, new_right))
            elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind2(v, old_left, new_left, old_right, new_right)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def window_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    window: Window,
    *on: Any,
    how: JoinKind = JoinKind.INNER,
) -> WindowJoinResult:
    return WindowJoinResult(
        self, other, self._resolve(self_time), other._resolve(other_time), window, on, how
    )


def window_join_inner(self: Table, other: Table, self_time: Any, other_time: Any, window: Window, *on: Any) -> WindowJoinResult:
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.INNER)


def window_join_left(self: Table, other: Table, self_time: Any, other_time: Any, window: Window, *on: Any) -> WindowJoinResult:
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.LEFT)


def window_join_right(self: Table, other: Table, self_time: Any, other_time: Any, window: Window, *on: Any) -> WindowJoinResult:
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.RIGHT)


def window_join_outer(self: Table, other: Table, self_time: Any, other_time: Any, window: Window, *on: Any) -> WindowJoinResult:
    return window_join(self, other, self_time, other_time, window, *on, how=JoinKind.OUTER)
