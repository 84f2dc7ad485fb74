"""Pagerank (port of ``pathway_tpu/stdlib/graphs/pagerank.py``)."""

from __future__ import annotations

import pathway_tpu_torch.internals.expression as expr
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def pagerank(edges: Table, steps: int = 5) -> Table:
    """Pagerank over an edge table with ``u``/``v`` pointer columns.

    Returns a table keyed by vertex with an int ``rank`` column (fixed-point scaled,
    damping 5/6, in integers).
    """
    in_vertices = edges.groupby(id=edges.v).reduce(degree=0)
    out_vertices = edges.groupby(id=edges.u).reduce(degree=reducers.count())
    degrees = in_vertices.update_rows(out_vertices)
    # vertices with outgoing edges only never receive flow: constant base rank
    base = out_vertices.difference(in_vertices).select(rank=1_000)

    ranks = degrees.select(rank=6_000)

    for _step in range(steps):
        outflow = degrees.select(
            flow=expr.if_else(
                degrees.degree == 0, 0, (ranks.rank * 5) // (degrees.degree * 6)
            ),
        )
        # flow is inlined onto the edges by a join, not an ix cross-table read
        contrib = edges.join(outflow, edges.u == outflow.id).select(
            v=edges.v, flow=outflow.flow
        )
        inflows = contrib.groupby(id=contrib.v).reduce(
            rank=reducers.sum(contrib.flow) + 1_000
        )
        combined = base.concat(inflows)
        combined.promise_universe_is_equal_to(degrees)
        ranks = combined.with_universe_of(degrees)

    return ranks
