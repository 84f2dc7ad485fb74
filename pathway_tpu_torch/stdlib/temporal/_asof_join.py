"""Asof and asof-now joins (port of ``pathway_tpu/stdlib/temporal/_asof_join.py``).

Mechanism: the right side aggregates per join-key into a sorted (time, rowid) tuple; each left
row binary-searches it for the latest-not-after (backward) / earliest-not-before (forward)
match. Incremental via groupby+ix (right updates re-trigger affected left rows).
"""

from __future__ import annotations

import bisect
import enum
from typing import Any, Dict

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.joins import JoinKind
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table, _name_of
from pathway_tpu_torch.internals import thisclass


class AsofDirection(enum.Enum):
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


Direction = AsofDirection


class AsofJoinResult:
    def __init__(
        self,
        left: Table,
        right: Table,
        left_time: expr.ColumnExpression,
        right_time: expr.ColumnExpression,
        on: tuple,
        kind: JoinKind,
        direction: AsofDirection,
        defaults: Dict[Any, Any] | None = None,
    ):
        self.left = left
        self.right = right
        self.left_time = left_time
        self.right_time = right_time
        self.on = on
        self.kind = kind
        self.direction = direction
        self.defaults = defaults or {}

    def _split_on(self) -> tuple[list, list]:
        import operator

        left_on: list[expr.ColumnExpression] = []
        right_on: list[expr.ColumnExpression] = []
        for cond in self.on:
            cond = thisclass.substitute(
                cond, {thisclass.left: self.left, thisclass.right: self.right}
            )
            assert (
                isinstance(cond, expr.ColumnBinaryOpExpression)
                and cond._operator is operator.eq
            ), "asof_join conditions must be equalities"
            a, b = cond._left, cond._right
            if any(r.table is self.left for r in a._column_refs):
                left_on.append(a)
                right_on.append(b)
            else:
                left_on.append(b)
                right_on.append(a)
        return left_on, right_on

    def select(self, *args: Any, **kwargs: Any) -> Table:
        """Asof semantics: every record of a
        participating side yields one output row, matched against the OTHER side's
        record selected by ``direction`` (backward = latest not-after). LEFT drives
        from the left records, RIGHT from the right, OUTER from both; ``pw.this``
        additionally exposes ``instance`` (join-key value), ``side`` (False =
        left-led) and ``t`` (the leading record's time)."""
        out_exprs: Dict[str, Any] = {}
        for arg in args:
            out_exprs[_name_of(arg)] = arg
        out_exprs.update(kwargs)

        left_on, right_on = self._split_on()
        parts: list[Table] = []
        if self.kind in (JoinKind.INNER, JoinKind.LEFT, JoinKind.OUTER):
            parts.append(self._side_part(False, left_on, right_on, out_exprs))
        if self.kind in (JoinKind.RIGHT, JoinKind.OUTER):
            parts.append(self._side_part(True, left_on, right_on, out_exprs))
        if len(parts) == 1:
            return parts[0]
        return parts[0].concat_reindex(*parts[1:])

    def _side_part(
        self, flipped: bool, left_on: list, right_on: list, out_exprs: Dict[str, Any]
    ) -> Table:
        if not flipped:
            lead, other = self.left, self.right
            lead_time, other_time = self.left_time, self.right_time
            lead_on, other_on = left_on, right_on
        else:
            lead, other = self.right, self.left
            lead_time, other_time = self.right_time, self.left_time
            lead_on, other_on = right_on, left_on

        ot = other.with_columns(_pw_t=other_time)
        ot2 = ot.with_columns(_pw_pair=expr.make_tuple(ot._pw_t, ot.id))
        if other_on:
            # group by the RAW key expressions: the group's output key is then
            # keys_from_values(values) == pointer_from(values), exactly what the
            # lead side derives for its ix lookup
            key_cols = {
                f"_pw_k{i}": _rebind_to(e, other, ot2) for i, e in enumerate(other_on)
            }
            keyed = ot2.with_columns(**key_cols)
            agg = keyed.groupby(*[keyed[n] for n in key_cols]).reduce(
                _pw_pairs=reducers.sorted_tuple(keyed._pw_pair)
            )
        else:
            agg = ot2.groupby().reduce(_pw_pairs=reducers.sorted_tuple(ot2._pw_pair))

        dt = lead.with_columns(_pw_t=lead_time)
        if lead_on:
            dkey = dt.pointer_from(*[_rebind_to(e, lead, dt) for e in lead_on])
        else:
            dkey = dt.pointer_from()
        pairs = agg.ix(dkey, optional=True)._pw_pairs

        direction = self.direction

        def pick(mytime: Any, pairs_tuple: Any) -> Any:
            # Tie-break follows the reference's merge order: at equal times, LEFT
            # events precede RIGHT events. A left-led row therefore sees
            # same-time right rows as "after" it (backward excludes them, forward
            # includes them); a right-led row sees same-time left rows as
            # "before" (backward inclusive, forward exclusive).
            if not pairs_tuple:
                return None
            times = [p[0] for p in pairs_tuple]
            inclusive_back = flipped  # right-led: at-or-before
            if direction == AsofDirection.BACKWARD:
                i = (
                    bisect.bisect_right(times, mytime)
                    if inclusive_back
                    else bisect.bisect_left(times, mytime)
                ) - 1
                return pairs_tuple[i][1] if i >= 0 else None
            if direction == AsofDirection.FORWARD:
                i = (
                    bisect.bisect_left(times, mytime)
                    if not flipped  # left-led: at-or-after
                    else bisect.bisect_right(times, mytime)
                )
                return pairs_tuple[i][1] if i < len(pairs_tuple) else None
            # nearest
            i = bisect.bisect_left(times, mytime)
            best = None
            for j in (i - 1, i):
                if 0 <= j < len(pairs_tuple):
                    d = abs(times[j] - mytime)
                    if best is None or d < best[0]:
                        best = (d, pairs_tuple[j][1])
            return best[1] if best else None

        match_ptr = expr.apply_with_type(pick, Any, dt._pw_t, pairs)
        with_match = dt.with_columns(_pw_match=match_ptr)
        if self.kind == JoinKind.INNER:
            with_match = with_match.filter(with_match._pw_match.is_not_none())
        omatch = other.ix(with_match._pw_match, optional=True)

        specials: Dict[str, Any] = {
            "side": expr.ColumnConstExpression(flipped),
            "t": with_match._pw_t,
        }
        if lead_on:
            inst = [_rebind_to(e, lead, with_match) for e in lead_on]
            specials["instance"] = inst[0] if len(inst) == 1 else expr.make_tuple(*inst)
        else:
            specials["instance"] = expr.ColumnConstExpression(None)

        resolved = {}
        for name, e in out_exprs.items():
            # pw.this.instance/side/t resolve to the asof result's virtual columns
            e = _resolve_specials(e, specials)
            e = thisclass.substitute(
                e,
                {thisclass.left: self.left, thisclass.right: self.right, thisclass.this: lead},
            )
            resolved[name] = _rebind_asof(
                e, lead, with_match, other, omatch, self.defaults, specials
            )
        return with_match.select(**resolved)


def _name_of_expr(e: Any, table: Table) -> str:
    return e.name if isinstance(e, expr.ColumnReference) else str(e)


def _rebind_to(e: Any, old: Table, new: Table) -> Any:
    if isinstance(e, expr.ColumnReference):
        return new[e.name] if e.table is old else e
    if isinstance(e, expr.ColumnExpression):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(clone, attr, _rebind_to(value, old, new))
            elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind_to(v, old, new) if isinstance(v, expr.ColumnExpression) else v
                        for v in value
                    ),
                )
        return clone
    return e


def _resolve_specials(e: Any, specials: Dict[str, Any]) -> Any:
    if isinstance(e, thisclass.ThisColumnReference) and e._kind is thisclass.this:
        # instance/side/t are the asof result's virtual columns and win over
        # same-named lead columns (pw.this.t is the merge time even when the
        # lead has a column "t")
        if e.name in specials:
            return specials[e.name]
        return e
    if isinstance(e, expr.ColumnExpression) and not isinstance(e, expr.ColumnReference):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(clone, attr, _resolve_specials(value, specials))
            elif isinstance(value, tuple) and any(
                isinstance(v, expr.ColumnExpression) for v in value
            ):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _resolve_specials(v, specials)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def _rebind_asof(
    e: Any,
    lead: Table,
    new_lead: Table,
    other: Table,
    omatch: Table,
    defaults: Dict,
    specials: Dict[str, Any],
) -> Any:
    """Rebind a select expression for one asof side-pass: lead refs hit the leading
    rows (``pw.this`` specials ``instance``/``side``/``t`` included), other-side refs
    hit the matched row with the configured default coalesced over a missing match."""
    if isinstance(e, expr.ColumnReference):
        if e.table is lead:
            if e.name in specials and e.name not in lead.column_names():
                return specials[e.name]
            return new_lead[e.name]
        if e.table is other:
            base = omatch[e.name]
            key = (id(other), e.name)
            if key in defaults:
                return expr.coalesce(base, defaults[key])
            return base
        return e
    if isinstance(e, expr.ColumnExpression):
        import copy

        clone = copy.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, expr.ColumnExpression):
                setattr(
                    clone,
                    attr,
                    _rebind_asof(value, lead, new_lead, other, omatch, defaults, specials),
                )
            elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
                setattr(
                    clone,
                    attr,
                    tuple(
                        _rebind_asof(v, lead, new_lead, other, omatch, defaults, specials)
                        if isinstance(v, expr.ColumnExpression)
                        else v
                        for v in value
                    ),
                )
        return clone
    return e


def asof_join(
    self: Table,
    other: Table,
    self_time: Any,
    other_time: Any,
    *on: Any,
    how: JoinKind = JoinKind.LEFT,
    defaults: Dict | None = None,
    direction: AsofDirection = AsofDirection.BACKWARD,
    behavior: Any = None,
) -> AsofJoinResult:
    defaults_by_ref: Dict[Any, Any] = {}
    if defaults:
        from pathway_tpu_torch.internals import thisclass

        for k, v in defaults.items():
            # keyed by (owning table, column name): both sides may default the same
            # column name (``defaults={t1.val: 0, t2.val: 0}``);
            # pw.left/pw.right keys substitute to their concrete tables first
            k = thisclass.substitute(k, {thisclass.left: self, thisclass.right: other})
            if isinstance(k, expr.ColumnReference):
                defaults_by_ref[(id(k.table), k.name)] = v
            else:
                defaults_by_ref[(id(other), k)] = v
    return AsofJoinResult(
        self,
        other,
        self._resolve(self_time),
        other._resolve(other_time),
        on,
        how,
        direction,
        defaults_by_ref,
    )


def asof_join_inner(self: Table, other: Table, self_time: Any, other_time: Any, *on: Any, **kw: Any) -> AsofJoinResult:
    kw.setdefault("how", JoinKind.INNER)
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_join_left(self: Table, other: Table, self_time: Any, other_time: Any, *on: Any, **kw: Any) -> AsofJoinResult:
    kw.setdefault("how", JoinKind.LEFT)
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_join_right(self: Table, other: Table, self_time: Any, other_time: Any, *on: Any, **kw: Any) -> AsofJoinResult:
    kw.setdefault("how", JoinKind.RIGHT)
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_join_outer(self: Table, other: Table, self_time: Any, other_time: Any, *on: Any, **kw: Any) -> AsofJoinResult:
    kw.setdefault("how", JoinKind.OUTER)
    return asof_join(self, other, self_time, other_time, *on, **kw)


# -- asof_now: query-stream semantics (no retraction of answers) -------------


def asof_now_join(self: Table, other: Table, *on: Any, how: JoinKind = JoinKind.INNER, **kw: Any):
    """Join where ``self`` is a query stream answered as of now."""
    from pathway_tpu_torch.stdlib.temporal._interval_join import _rebind

    forgotten = self._forget_immediately()
    # user expressions reference the original left table; rebind them onto the
    # forgetting copy
    on = tuple(_rebind(cond, self, forgotten, other, other) for cond in on)
    result = forgotten.join(other, *on, how=how, **kw)
    left_table = self

    class _AsofNowJoinResult:
        def select(self, *args: Any, **kwargs: Any) -> Table:
            args = tuple(
                _rebind(a, left_table, forgotten, other, other) for a in args
            )
            kwargs = {
                k: _rebind(v, left_table, forgotten, other, other)
                for k, v in kwargs.items()
            }
            selected = result.select(*args, **kwargs)
            return selected._filter_out_results_of_forgetting()

    return _AsofNowJoinResult()


def asof_now_join_inner(self: Table, other: Table, *on: Any, **kw: Any):
    return asof_now_join(self, other, *on, how=JoinKind.INNER, **kw)


def asof_now_join_left(self: Table, other: Table, *on: Any, **kw: Any):
    return asof_now_join(self, other, *on, how=JoinKind.LEFT, **kw)
