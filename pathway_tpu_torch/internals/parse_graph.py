"""Global operator DAG built by the Table API (port of ``pathway_tpu/internals/parse_graph.py``).

Each node couples the declarative spec with what the runner needs to build
its incremental evaluator. The port has every node kind of the
reference but ``stateful_reduce`` (the reference builds it nowhere and runs
it nowhere).

``G`` is a proxy for the graph being built: ``pw.iterate`` swaps it to a
private nested graph while it builds the iteration body.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from pathway_tpu_torch.internals.trace import capture_user_frame

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class Node:
    """One operator in the dataflow DAG."""

    kind: str = "node"

    def __init__(self, **config: Any):
        self.id: int = -1
        self.config: Dict[str, Any] = config
        self.inputs: List["Table"] = config.pop("inputs", [])
        self.output: Optional["Table"] = None
        self.name: str = config.pop("name", self.kind)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} #{self.id} {self.name}>"


class InputNode(Node):
    kind = "input"


class RowwiseNode(Node):
    kind = "rowwise"


class FilterNode(Node):
    kind = "filter"


class ReindexNode(Node):
    kind = "reindex"


class GroupbyNode(Node):
    kind = "groupby"


class JoinNode(Node):
    kind = "join"


class ConcatNode(Node):
    kind = "concat"


class FlattenNode(Node):
    kind = "flatten"


class IxNode(Node):
    kind = "ix"


class DeduplicateNode(Node):
    kind = "deduplicate"


class UpdateCellsNode(Node):
    kind = "update_cells"


class WithUniverseOfNode(Node):
    kind = "with_universe_of"


class SortNode(Node):
    kind = "sort"


class SortedIndexNode(Node):
    """Sorted binary tree per instance (``stdlib/indexing/sorting.py``
    ``build_sorted_index``): one row per input row with left / right /
    parent tree pointers."""

    kind = "sorted_index"


class GradualBroadcastNode(Node):
    """Threshold broadcast with a per-key stagger and hysteresis."""

    kind = "gradual_broadcast"


class IterateNode(Node):
    kind = "iterate"


class IterateResultNode(Node):
    kind = "iterate_result"


class RemoveErrorsNode(Node):
    kind = "remove_errors"


class OutputNode(Node):
    """A sink: subscribe callback, io writer, or debug capture."""

    kind = "output"


class ExternalIndexNode(Node):
    kind = "external_index"


class UpdateRowsNode(Node):
    kind = "update_rows"


class IntersectNode(Node):
    kind = "intersect"


class DifferenceNode(Node):
    kind = "difference"


class RestrictNode(Node):
    kind = "restrict"


class HavingNode(Node):
    kind = "having"


class AsofNowUpdateNode(Node):
    """``_forget_immediately`` (mode ``forget``) or
    ``_filter_out_results_of_forgetting`` (mode ``filter_forgotten``)."""

    kind = "asof_now"


class BufferNode(Node):
    kind = "buffer"


class ForgetNode(Node):
    kind = "forget"


class FreezeNode(Node):
    kind = "freeze"


class RowTransformerNode(Node):
    """``@pw.transformer``: one output table per class argument; the node's
    own output is the first argument's."""

    kind = "row_transformer"


class RowTransformerResultNode(Node):
    """Reads a row transformer's output for one further class argument."""

    kind = "row_transformer_result"


class TimedSourceClock:
    """Serializes debug ``_TimedSource`` streams onto one global clock.

    Each poll round (one ``next_batch`` call per live source) releases the rows of
    exactly one globally-minimal ``__time__`` value, so interleaved streams arrive in
    deterministic commit order. The round's minimum is snapshotted when the round
    starts; a source re-polled within the commit cannot shift it.
    """

    def __init__(self) -> None:
        self.sources: List[Any] = []
        self._polled: set[int] = set()
        self._round_min: Any = None

    def clear(self) -> None:
        self.sources.clear()
        self._polled.clear()
        self._round_min = None

    def register(self, source: Any) -> None:
        self.sources.append(source)

    def may_release(self, source: Any) -> bool:
        pending = [t for t in (s._next_time() for s in self.sources) if t is not None]
        if not pending:
            return True
        if id(source) in self._polled or self._round_min is None:
            # a source polled twice means a new commit began: start a fresh round
            self._polled = set()
            self._round_min = min(pending)
        self._polled.add(id(source))
        nt = source._next_time()
        return nt is not None and nt == self._round_min


_GLOBAL_UNIVERSE_COUNTER = itertools.count()


class ParseGraph:
    """Global mutable DAG; cleared by ``G.clear()`` between test runs."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.error_logs: List["Table"] = []
        # shared clock for debug _TimedSource streams (global __time__ order)
        self.timed_source_clock = TimedSourceClock()

    def add_node(self, node: Node) -> Node:
        node.id = len(self.nodes)
        # the user line that built the operator: the error log's trace
        node.user_frame = capture_user_frame()
        # operators built inside a local_error_log context report there
        stack = getattr(self, "_error_log_stack", None)
        node.error_log_source = stack[-1] if stack else None
        self.nodes.append(node)
        return node

    def new_universe_id(self) -> int:
        # process-wide: iterate's nested graphs share the one solver
        return next(_GLOBAL_UNIVERSE_COUNTER)

    def clear(self) -> None:
        self.nodes.clear()
        self.error_logs.clear()
        # the global error log belonged to the dropped nodes (the reference
        # keeps its table, whose node a cleared graph no longer holds)
        for attr in ("_global_error_log", "_error_log_source", "_error_log_stack"):
            self.__dict__.pop(attr, None)
        self.timed_source_clock.clear()
        # relations of the dropped graph's universes are garbage (ids are global
        # and never reused, but unbounded growth across test runs serves nothing)
        universe_solver.clear()

    def sig(self) -> str:
        """The graph's signature in a persistence store: node ids, kinds and
        input ids (the reference's, for the same nodes)."""
        digest = hashlib.sha256()
        for node in self.nodes:
            digest.update(f"{node.id}:{node.kind}:{[t._node.id for t in node.inputs]}".encode())
        return digest.hexdigest()



class _GraphProxy:
    """Delegates to the graph being built; ``pw.iterate`` points
    ``_current`` at its nested graph while the iteration body is built."""

    def __init__(self) -> None:
        self._current = ParseGraph()

    def __getattr__(self, name: str):
        return getattr(self._current, name)


G = _GraphProxy()


@dataclass(frozen=True)
class Universe:
    """Key-set identity of a table."""

    uid: int


class UniverseSolver:
    """Key-set (universe) algebra: the queries resolve by structural derivation.

    Universes are related by subset/equal promises AND by the algebra of the ops
    that created them: an intersection is contained in each parent, a union
    contains each part, a difference is contained in its left argument and is
    disjoint from its right. ``query_is_subset`` derives through all of these.
    """

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self.subset: set[tuple[int, int]] = set()
        self.equal: dict[int, int] = {}
        self.intersections: dict[int, list[int]] = {}
        self.unions: dict[int, list[int]] = {}
        self.differences: dict[int, tuple[int, int]] = {}
        self.disjoint: set[tuple[int, int]] = set()

    def _root(self, u: int) -> int:
        while self.equal.get(u, u) != u:
            u = self.equal[u]
        return u

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self.subset.add((self._root(sub.uid), self._root(sup.uid)))

    def register_equal(self, a: Universe, b: Universe) -> None:
        self.equal[self._root(a.uid)] = self._root(b.uid)

    def register_intersection(self, result: Universe, parents: list) -> None:
        roots = [self._root(p.uid) for p in parents]
        r = self._root(result.uid)
        self.intersections[r] = roots
        for p in roots:
            self.subset.add((r, p))

    def register_union(self, result: Universe, parts: list) -> None:
        roots = [self._root(p.uid) for p in parts]
        r = self._root(result.uid)
        self.unions[r] = roots
        for p in roots:
            self.subset.add((p, r))

    def register_difference(self, result: Universe, a: Universe, b: Universe) -> None:
        r = self._root(result.uid)
        self.differences[r] = (self._root(a.uid), self._root(b.uid))
        self.subset.add((r, self._root(a.uid)))
        self._register_disjoint_roots(r, self._root(b.uid))

    def register_disjoint(self, a: Universe, b: Universe) -> None:
        self._register_disjoint_roots(self._root(a.uid), self._root(b.uid))

    def _register_disjoint_roots(self, a: int, b: int) -> None:
        self.disjoint.add((a, b))
        self.disjoint.add((b, a))

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        return self._subset_roots(self._root(sub.uid), self._root(sup.uid), set())

    def _subset_roots(self, a: int, b: int, busy: set) -> bool:
        if a == b:
            return True
        if (a, b) in busy:
            return False  # cycle guard for structural recursion
        busy = busy | {(a, b)}
        # transitive subset edges
        seen = {a}
        frontier = [a]
        while frontier:
            u = frontier.pop()
            if u == b:
                return True
            for (x, y) in self.subset:
                if x == u and y not in seen:
                    seen.add(y)
                    frontier.append(y)
        # a <= intersection(P...) iff a <= every P
        parents = self.intersections.get(b)
        if parents and all(self._subset_roots(a, p, busy) for p in parents):
            return True
        # union(Q...) <= b iff every Q <= b
        parts = self.unions.get(a)
        if parts and all(self._subset_roots(q, b, busy) for q in parts):
            return True
        return False

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self._root(a.uid) == self._root(b.uid) or (
            self.query_is_subset(a, b) and self.query_is_subset(b, a)
        )

    def query_are_disjoint(self, a: Universe, b: Universe) -> bool:
        ra, rb = self._root(a.uid), self._root(b.uid)
        if (ra, rb) in self.disjoint:
            return True
        # subsets of disjoint universes are disjoint
        for (x, y) in self.disjoint:
            if self._subset_roots(ra, x, set()) and self._subset_roots(rb, y, set()):
                return True
        return False


universe_solver = UniverseSolver()


def new_universe() -> Universe:
    return Universe(G.new_universe_id())
