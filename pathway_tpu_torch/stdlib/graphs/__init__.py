"""Graph algorithms (port of ``pathway_tpu/stdlib/graphs``): pagerank,
bellman_ford and louvain_communities, all built from incremental Table ops."""

from __future__ import annotations

from pathway_tpu_torch.stdlib.graphs.common import Edge, Vertex, Weight, Clustering, Graph, WeightedGraph
from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
from pathway_tpu_torch.stdlib.graphs.bellman_ford import bellman_ford
from pathway_tpu_torch.stdlib.graphs.louvain_communities import (
    exact_modularity,
    louvain_communities,
    louvain_level,
)

__all__ = [
    "Edge",
    "Vertex",
    "Weight",
    "Clustering",
    "Graph",
    "WeightedGraph",
    "pagerank",
    "bellman_ford",
    "louvain_communities",
    "louvain_level",
    "exact_modularity",
]
