"""Graph containers (port of ``pathway_tpu/stdlib/graphs/common.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals.table import Table


class Vertex:
    """Schema marker."""


class Edge:
    """Edges have pointer columns ``u``, ``v``."""


class Weight:
    """Weighted edges additionally carry a float ``weight``."""


class Clustering:
    """A clustering assigns each vertex a cluster pointer ``c``."""


def _extended_to_full_clustering(vertices: Table, clustering: Table) -> Table:
    """Vertices missing from ``clustering`` become singleton clusters (their own id)."""
    return vertices.select(c=vertices.id).update_rows(clustering)


@dataclass
class Graph:
    """Undirected unweighted (multi)graph: vertex table + ``u``/``v`` edge table."""

    V: Table
    E: Table

    def contracted_to_multi_graph(self, clustering: Table) -> "Graph":
        full = _extended_to_full_clustering(self.V, clustering)
        return Graph(_contract_vertices(full), _contract_edges(self.E, full, keep=[]))

    def without_self_loops(self) -> "Graph":
        return Graph(self.V, self.E.filter(self.E.u != self.E.v))


def _contract_vertices(full_clustering: Table) -> Table:
    grouped = full_clustering.groupby(full_clustering.c).reduce(v=full_clustering.c)
    return grouped.with_id(grouped.v)


def _contract_edges(edges: Table, full_clustering: Table, *, keep: list[str]) -> Table:
    exprs = {
        "u": full_clustering.ix(edges.u).c,
        "v": full_clustering.ix(edges.v).c,
    }
    for name in keep:
        exprs[name] = edges[name]
    return edges.select(**exprs)


@dataclass
class WeightedGraph(Graph):
    """Graph whose edges carry weights; ``WE`` has columns ``u``, ``v``, ``weight``."""

    WE: Table = None  # type: ignore[assignment]

    @staticmethod
    def from_vertices_and_weighted_edges(V: Table, WE: Table) -> "WeightedGraph":
        return WeightedGraph(V, WE, WE)

    def contracted_to_multi_graph(self, clustering: Table) -> "WeightedGraph":
        full = _extended_to_full_clustering(self.V, clustering)
        contracted = _contract_edges(self.WE, full, keep=["weight"])
        return WeightedGraph.from_vertices_and_weighted_edges(
            _contract_vertices(full), contracted
        )

    def contracted_to_weighted_simple_graph(self, clustering: Table, **reducer_expressions: Any) -> "WeightedGraph":
        contracted = self.contracted_to_multi_graph(clustering)
        we = contracted.WE
        simple = we.groupby(we.u, we.v).reduce(we.u, we.v, **reducer_expressions)
        return WeightedGraph.from_vertices_and_weighted_edges(contracted.V, simple)

    def without_self_loops(self) -> "WeightedGraph":
        return WeightedGraph.from_vertices_and_weighted_edges(
            self.V, self.WE.filter(self.WE.u != self.WE.v)
        )
