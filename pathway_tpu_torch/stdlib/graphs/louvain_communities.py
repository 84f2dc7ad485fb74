"""Louvain community detection.

Port of ``pathway_tpu/stdlib/graphs/louvain_communities.py``: the parallel-move Louvain:
each round proposes, for every vertex, the adjacent cluster maximizing the modularity gain,
then executes an independent set of moves (no cluster participates in two moves, decided by
deterministic hash priorities) so rounds are order-independent and incremental.

The total edge weight is attached through a singleton aggregate keyed by the empty group
key, and move priorities come from the engine's 128-bit key fingerprints, so a clustering
is a function of the graph and its vertex keys.
"""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.expression as expr
from pathway_tpu_torch.internals.keys import pointer_from
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.graphs.common import WeightedGraph
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows


def _total_weight(edges: Table) -> Table:
    """Singleton table with the total edge weight ``m`` (keyed by the empty group key)."""
    return edges.groupby().reduce(m=reducers.sum(edges.weight))


def _propose_clusters(edges: Table, clustering: Table, total: Table) -> Table:
    """For each vertex, the adjacent cluster that locally maximizes the Louvain gain.

    ``edges``: directed (both directions present for undirected graphs), columns
    ``u``/``v``/``weight``. ``clustering``: keyed by vertex, column ``c``.
    Gain of moving v into cluster C' (unnormalized):
    ``2*deg(v in C') - deg(v) * (2*deg(C') + deg(v)) / m``.
    """
    # sum of degrees per cluster (penalty term); zero placeholder so empty clusters exist
    placeholder_penalties = clustering.groupby(id=clustering.c).reduce(unscaled_penalty=0.0)
    by_u_cluster = edges.select(weight=edges.weight, cu=clustering.ix(edges.u).c)
    real_penalties = by_u_cluster.groupby(id=by_u_cluster.cu).reduce(
        unscaled_penalty=reducers.sum(by_u_cluster.weight)
    )
    cluster_penalties = placeholder_penalties.update_rows(real_penalties)

    # placeholder 0-degree rows keep isolated vertices representable (they still get
    # proposal rows via the placeholder vertex→own-cluster edges below)
    real_degrees = edges.groupby(id=edges.v).reduce(degree=reducers.sum(edges.weight))
    vertex_degrees = clustering.select(degree=0.0).update_rows(real_degrees)

    # self loops contribute to every candidate cluster equally; handled separately
    self_loops = edges.filter(edges.u == edges.v)
    loops_rekeyed = self_loops.with_id(self_loops.v)
    self_loop_by_v = loops_rekeyed.select(contr=loops_rekeyed.weight)
    self_loop_contribution = clustering.select(contr=0.0).update_rows(self_loop_by_v)

    proper = edges.filter(edges.u != edges.v)

    # vertex→cluster graph; zero-weight edges from each vertex to its own cluster keep
    # clusters with no incoming edges representable
    placeholder_edges = clustering.select(u=clustering.id, vc=clustering.c, weight=0.0)
    real_vc_edges = proper.select(
        u=proper.u, vc=clustering.ix(proper.v).c, weight=proper.weight
    )
    vertex_cluster_edges = placeholder_edges.concat_reindex(real_vc_edges)

    aggregated_gain = vertex_cluster_edges.groupby(
        vertex_cluster_edges.u, vertex_cluster_edges.vc
    ).reduce(
        vertex_cluster_edges.u,
        vertex_cluster_edges.vc,
        gain=reducers.sum(vertex_cluster_edges.weight),
    )
    # self-loop weight counts half (created doubled by contraction)
    aggregated_gain = aggregated_gain.select(
        aggregated_gain.u,
        aggregated_gain.vc,
        gain=aggregated_gain.gain
        + self_loop_contribution.ix(aggregated_gain.u).contr / 2.0,
    )

    def louvain_gain(gain: float, degree: float, penalty: float, total_w: float) -> float:
        return 2.0 * gain - degree * (2.0 * penalty + degree) / total_w

    gain_from_moving = aggregated_gain.select(
        aggregated_gain.u,
        aggregated_gain.vc,
        gain=expr.apply_with_type(
            louvain_gain,
            float,
            aggregated_gain.gain,
            vertex_degrees.ix(aggregated_gain.u).degree,
            cluster_penalties.ix(aggregated_gain.vc).unscaled_penalty,
            total.ix(aggregated_gain.pointer_from()).m,
        ),
    )

    # staying in the current cluster: remove own degree from the penalty
    stay_keyed = clustering.select(u=clustering.id, vc=clustering.c)
    gain_for_staying = stay_keyed.select(
        stay_keyed.u,
        stay_keyed.vc,
        gain=expr.apply_with_type(
            louvain_gain,
            float,
            # the aggregated gain for (u, own cluster) always exists via placeholder edges
            aggregated_gain.ix(
                stay_keyed.pointer_from(stay_keyed.u, stay_keyed.vc)
            ).gain,
            vertex_degrees.ix(stay_keyed.u).degree,
            cluster_penalties.ix(stay_keyed.vc).unscaled_penalty
            - vertex_degrees.ix(stay_keyed.u).degree,
            total.ix(stay_keyed.pointer_from()).m,
        ),
    )
    gain_for_staying = gain_for_staying.with_id_from(
        gain_for_staying.u, gain_for_staying.vc
    )

    moving_keyed = gain_from_moving.with_id_from(gain_from_moving.u, gain_from_moving.vc)
    ret = moving_keyed.update_rows(gain_for_staying)
    best = argmax_rows(ret, ret.u, what=ret.gain)
    rebased = best.with_id(best.u)
    proposal = rebased.select(c=rebased.vc)
    proposal.promise_universe_is_equal_to(clustering)
    return proposal.with_universe_of(clustering)


def _one_step(graph: WeightedGraph, clustering: Table, total: Table, iteration: int) -> Table:
    """One parallel Louvain round: propose moves, pick a cluster-disjoint subset, apply."""
    proposed = _propose_clusters(graph.WE, clustering, total)
    moves = proposed.filter(proposed.c != clustering.ix(proposed.id).c)
    candidate_moves = moves.select(
        u=moves.id,
        uc=clustering.ix(moves.id).c,
        vc=moves.c,
    )

    # deterministic per-(vertex, round) priority from the engine fingerprint
    def rand(p: Any, it: int = iteration) -> int:
        return int(pointer_from(p, it, "louvain").lo % (2**62))

    candidate_moves = candidate_moves.with_columns(
        r=expr.apply_with_type(rand, int, candidate_moves.u)
    )

    out_priorities = candidate_moves.select(candidate_moves.r, c=candidate_moves.uc)
    in_priorities = candidate_moves.select(candidate_moves.r, c=candidate_moves.vc)
    all_priorities = out_priorities.concat_reindex(in_priorities)
    maxima = argmax_rows(all_priorities, all_priorities.c, what=all_priorities.r)
    cluster_max_priority = maxima.with_id(maxima.c)

    winners = candidate_moves.filter(
        (candidate_moves.r == cluster_max_priority.ix(candidate_moves.uc).r)
        & (candidate_moves.r == cluster_max_priority.ix(candidate_moves.vc).r)
    )
    winners_rebased = winners.with_id(winners.u)
    delta = winners_rebased.select(c=winners_rebased.vc)
    updated = clustering.update_rows(delta)
    updated.promise_universe_is_equal_to(clustering)
    return updated.with_universe_of(clustering)


def louvain_level(graph: WeightedGraph, number_of_iterations: int = 10, *, total: Table | None = None) -> Table:
    """Run Louvain rounds on one level; returns a clustering keyed by vertex with ``c``.

    Fresh cluster ids are derived from vertex ids, so every cluster id is one of its
    members.
    """
    if total is None:
        total = _total_weight(graph.WE)
    clustering = graph.V.select(c=graph.V.id)
    for iteration in range(number_of_iterations):
        clustering = _one_step(graph, clustering, total, iteration)
    return clustering


def louvain_communities(
    graph: WeightedGraph,
    levels: int = 1,
    iterations_per_level: int = 10,
) -> Table:
    """Hierarchical Louvain: run a level, contract clusters to vertices, repeat.

    Returns the flattened clustering of the *original* vertices after ``levels`` levels
    (column ``c``): the final level's flat clustering.
    """
    total = _total_weight(graph.WE)
    # flat[v] = current cluster of original vertex v
    flat = graph.V.select(c=graph.V.id)
    level_graph = graph
    for _ in range(levels):
        clustering = louvain_level(level_graph, iterations_per_level, total=total)
        flat = flat.select(c=clustering.ix(flat.c).c)
        level_graph = level_graph.contracted_to_weighted_simple_graph(
            clustering, weight=reducers.sum(level_graph.WE.weight)
        )
    return flat


def exact_modularity(graph: WeightedGraph, clustering: Table, round_digits: int = 16) -> Table:
    """Modularity of ``clustering`` on ``graph`` (a testing helper)."""
    C = clustering
    WE = graph.WE
    clusters = C.groupby(id=C.c).reduce()

    by_cu = WE.select(WE.weight, cu=C.ix(WE.u).c)
    degrees = clusters.with_columns(degree=0.0).update_rows(
        by_cu.groupby(id=by_cu.cu).reduce(degree=reducers.sum(by_cu.weight))
    )
    both_ends = WE.select(WE.weight, cu=C.ix(WE.u).c, cv=C.ix(WE.v).c)
    internal_edges = both_ends.filter(both_ends.cu == both_ends.cv)
    internal = clusters.with_columns(internal=0.0).update_rows(
        internal_edges.groupby(id=internal_edges.cu).reduce(
            internal=reducers.sum(internal_edges.weight)
        )
    )
    total = _total_weight(WE)

    def cluster_modularity(internal_w: float, degree: float, total_w: float) -> float:
        return (internal_w * total_w - degree * degree) / (total_w * total_w)

    score = clusters.select(
        modularity=expr.apply_with_type(
            cluster_modularity,
            float,
            internal.ix(clusters.id).internal,
            degrees.ix(clusters.id).degree,
            total.ix(clusters.pointer_from()).m,
        )
    )
    summed = score.reduce(modularity=reducers.sum(score.modularity))
    return summed.select(
        modularity=expr.apply_with_type(
            lambda x, nd=round_digits: round(x, nd), float, summed.modularity
        )
    )
