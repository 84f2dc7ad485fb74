"""Global operator DAG built by the Table API (port of ``pathway_tpu/internals/parse_graph.py``).

Each node couples the declarative spec with what the runner needs to build
its incremental evaluator. The port keeps the node kinds of its slices:
input, rowwise (select), filter, reindex, concat, groupby, join, flatten,
ix, external index and output, the key-presence operators (update_rows,
intersect, difference, restrict, having) and the time-threshold operators
of ``pw.temporal`` (buffer, freeze, forget, asof_now).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional

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
        # shared clock for debug _TimedSource streams (global __time__ order)
        self.timed_source_clock = TimedSourceClock()

    def add_node(self, node: Node) -> Node:
        node.id = len(self.nodes)
        self.nodes.append(node)
        return node

    def new_universe_id(self) -> int:
        return next(_GLOBAL_UNIVERSE_COUNTER)

    def clear(self) -> None:
        self.nodes.clear()
        self.timed_source_clock.clear()
        # relations of the dropped graph's universes are garbage (ids are global
        # and never reused, but unbounded growth across test runs serves nothing)
        universe_solver.clear()



G = ParseGraph()


@dataclass(frozen=True)
class Universe:
    """Key-set identity of a table."""

    uid: int


class UniverseSolver:
    """Key-set (universe) relations: a filter's or a difference's universe is
    a subset of its input's, each part is a subset of a union, and two
    universes are equal when each is a subset of the other (the reference
    derives more relations; the port's operators need these)."""

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self.subset: set[tuple[int, int]] = set()

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self.subset.add((sub.uid, sup.uid))

    def register_union(self, result: Universe, parts: list) -> None:
        for p in parts:
            self.subset.add((p.uid, result.uid))

    def register_difference(self, result: Universe, a: Universe, b: Universe) -> None:
        self.subset.add((result.uid, a.uid))

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        seen = {sub.uid}
        frontier = [sub.uid]
        while frontier:
            u = frontier.pop()
            if u == sup.uid:
                return True
            for x, y in self.subset:
                if x == u and y not in seen:
                    seen.add(y)
                    frontier.append(y)
        return False

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return a.uid == b.uid or (self.query_is_subset(a, b) and self.query_is_subset(b, a))


universe_solver = UniverseSolver()


def new_universe() -> Universe:
    return Universe(G.new_universe_id())
