"""Incremental Hidden-Markov-Model decoding as a custom reducer (port of
``pathway_tpu/stdlib/ml/hmm.py``).

The reducer consumes a stream of observations grouped per key and maintains a
Viterbi beam incrementally: each new observation advances per-state best
log-probabilities and back-paths in one pass over the transition graph — no
re-decode of the history, so a long-running stream pays O(states * degree) per
update. Used as ``pw.reducers.udf_reducer(create_hmm_reducer(graph))``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator


def create_hmm_reducer(
    graph: Any,
    beam_size: int | None = None,
    num_results_kept: int | None = None,
) -> type:
    """Build an accumulator class decoding the HMM described by ``graph``.

    ``graph``: a ``networkx.DiGraph`` whose nodes carry ``calc_emission_log_ppb``
    (callable observation -> log-probability), edges carry
    ``log_transition_ppb``, and ``graph.graph["start_nodes"]`` lists initial
    states. ``beam_size`` keeps only the top-k states per step;
    ``num_results_kept`` bounds the reported path suffix (and the stored
    back-paths, so memory stays constant over unbounded streams).
    """
    start_nodes = list(graph.graph.get("start_nodes", graph.nodes))
    emission = {s: graph.nodes[s]["calc_emission_log_ppb"] for s in graph.nodes}
    transitions: dict[Any, list[tuple[Any, float]]] = {
        s: [
            (succ, float(graph.edges[s, succ]["log_transition_ppb"]))
            for succ in graph.successors(s)
        ]
        for s in graph.nodes
    }
    keep = num_results_kept

    def advance(beam: dict | None, obs: Any) -> dict:
        if beam is None:
            new = {
                s: (float(emission[s](obs)), (s,))
                for s in start_nodes
            }
        else:
            new = {}
            for s1, (lp, path) in beam.items():
                for s2, trans_lp in transitions[s1]:
                    cand = lp + trans_lp + float(emission[s2](obs))
                    cur = new.get(s2)
                    if cur is None or cand > cur[0]:
                        suffix = path + (s2,)
                        if keep is not None:
                            suffix = suffix[-keep:]
                        new[s2] = (cand, suffix)
        if beam_size is not None and len(new) > beam_size:
            top = sorted(new.items(), key=lambda kv: -kv[1][0])[:beam_size]
            new = dict(top)
        return new

    class HmmAccumulator(BaseCustomAccumulator):
        def __init__(self, observations: list):
            self.pending = list(observations)
            self.beam: dict | None = None

        @classmethod
        def from_row(cls, row: list) -> "HmmAccumulator":
            return cls([row[0]])

        def _drain(self) -> None:
            for obs in self.pending:
                self.beam = advance(self.beam, obs)
            self.pending = []

        def update(self, other: "HmmAccumulator") -> None:
            self._drain()
            for obs in other.pending:
                self.beam = advance(self.beam, obs)

        def compute_result(self) -> tuple:
            self._drain()
            if not self.beam:
                return ()
            _, path = max(self.beam.values(), key=lambda v: v[0])
            return tuple(path)

    return HmmAccumulator
