"""Bellman-Ford shortest paths (port of ``pathway_tpu/stdlib/graphs/bellman_ford.py``).

The edges are an argument of the iteration, so the nested graph reads them:
the reference's body reads its outer ``edges`` table, which its nested
runner cannot see, and leaves every vertex but the sources at ``inf``.
"""

from __future__ import annotations

import math

import pathway_tpu_torch.internals.expression as expr
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """Single-source shortest paths: ``vertices`` needs ``is_source``; ``edges`` needs
    ``u``, ``v``, ``dist``."""
    initial = vertices.select(
        dist_from_source=expr.if_else(vertices.is_source, 0.0, math.inf)
    )

    def one_step(state: Table, edges: Table) -> dict:
        relaxed = edges.select(
            v=edges.v,
            dist=state.ix(edges.u).dist_from_source + edges.dist,
        )
        best = relaxed.groupby(relaxed.v).reduce(
            v=relaxed.v, best=reducers.min(relaxed.dist)
        )
        best_by_vertex = best.with_id(best.v)
        new_state = state.select(
            dist_from_source=expr.coalesce(
                expr.apply_with_type(
                    lambda cur, new: min(cur, new) if new is not None else cur,
                    float,
                    state.dist_from_source,
                    best_by_vertex.ix(state.id, optional=True).best,
                ),
                state.dist_from_source,
            )
        )
        return dict(state=new_state)

    result = iterate(one_step, iteration_limit=50, state=initial, edges=edges)
    return result.state
