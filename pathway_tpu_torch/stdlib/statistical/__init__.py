"""Statistical helpers (port of ``pathway_tpu/stdlib/statistical``): ``interpolate``.

``interpolate`` resolves each None cell against the NEAREST non-None neighbors
in timestamp order, across runs of Nones of any length:
nearest-known (t, v) pairs propagate along sort-order pointers to a fixpoint
with ``pw.iterate`` (pointer doubling, O(log run-length) rounds), then one pass
computes the blend. Chain state carries explicit validity flags — float columns
materialize None as NaN, so None-sentinels cannot drive the propagation.
"""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def interpolate(
    table: Table, timestamp: Any, *values: Any, mode: InterpolateMode | None = None
) -> Table:
    """Linearly interpolate missing (None) values along ``timestamp`` order."""
    import pathway_tpu_torch as pw

    mode = mode or InterpolateMode.LINEAR
    ts_name = timestamp.name if hasattr(timestamp, "name") else str(timestamp)
    names = [v.name if hasattr(v, "name") else str(v) for v in values]

    sorted_t = table.sort(timestamp)

    def _known(v: Any) -> bool:
        # missing = None OR NaN: float columns materialize absent cells as NaN
        return v is not None and v == v

    result = table
    for name in names:
        known = expr.apply_with_type(_known, bool, table[name])
        state0 = table.select(
            prev_ptr=sorted_t.prev,
            next_ptr=sorted_t.next,
            t=table[ts_name],
            cur=table[name],
            ok=known,
            pt=expr.if_else(known, table[ts_name], 0.0 * table[ts_name]),
            pv=expr.coalesce(table[name], 0.0),
            p_ok=known,
            nt=expr.if_else(known, table[ts_name], 0.0 * table[ts_name]),
            nv=expr.coalesce(table[name], 0.0),
            n_ok=known,
        )

        def step(state: Table) -> Table:
            prev_row = state.ix(state.prev_ptr, optional=True)
            next_row = state.ix(state.next_ptr, optional=True)
            prev_ok = expr.coalesce(prev_row.p_ok, False)
            next_ok = expr.coalesce(next_row.n_ok, False)
            return state.select(
                # pointer doubling: an unresolved row whose neighbor is also
                # unresolved jumps over it, so a None-run of length L closes in
                # O(log L) iterations
                prev_ptr=expr.if_else(
                    ~state.p_ok & ~prev_ok, prev_row.prev_ptr, state.prev_ptr
                ),
                next_ptr=expr.if_else(
                    ~state.n_ok & ~next_ok, next_row.next_ptr, state.next_ptr
                ),
                t=state.t,
                cur=state.cur,
                ok=state.ok,
                pt=expr.if_else(state.p_ok, state.pt, expr.coalesce(prev_row.pt, 0.0)),
                pv=expr.if_else(state.p_ok, state.pv, expr.coalesce(prev_row.pv, 0.0)),
                p_ok=state.p_ok | prev_ok,
                nt=expr.if_else(state.n_ok, state.nt, expr.coalesce(next_row.nt, 0.0)),
                nv=expr.if_else(state.n_ok, state.nv, expr.coalesce(next_row.nv, 0.0)),
                n_ok=state.n_ok | next_ok,
            )

        resolved = pw.iterate(lambda state: dict(state=step(state)), state=state0).state
        resolved.promise_universe_is_equal_to(table)
        aligned = resolved.with_universe_of(table)

        def interp(
            t: Any, cur: Any, pt: Any, pv: Any, p_ok: Any, nt: Any, nv: Any, n_ok: Any
        ) -> Any:
            if cur is not None and cur == cur:
                return cur
            if p_ok and n_ok and nt != pt:
                return pv + (nv - pv) * (t - pt) / (nt - pt)
            if p_ok:
                return pv
            if n_ok:
                return nv
            return None

        # emit from the ITERATED table (update_cells reacts to patch-side
        # deltas): a late-arriving known point re-resolves chains inside the
        # iterate, and the re-interpolated cells must flow even though the base
        # rows saw no delta of their own
        filled = aligned.select(
            **{
                name: expr.apply_with_type(
                    interp,
                    float,
                    aligned.t,
                    aligned.cur,
                    aligned.pt,
                    aligned.pv,
                    aligned.p_ok,
                    aligned.nt,
                    aligned.nv,
                    aligned.n_ok,
                )
            }
        )
        result = result.update_cells(filled)
    return result
