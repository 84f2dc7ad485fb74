"""The commit loop (port of ``pathway_tpu/engine/runner.py``, single process).

Each commit gathers one batch per source, pushes deltas through the operator
DAG in topological order and delivers outputs. Timestamps are even integers
(data times), as in the reference. The port runs one process with operator
fusion off; persistence, checkpoints, cluster routing, membership, tracing,
profiling and the lint gate are not ported. Each operator's host seconds
accumulate in :attr:`GraphRunner.node_seconds`, and each commit that moved
rows logs (seconds, input rows) in :attr:`GraphRunner.commit_log`.
"""

from __future__ import annotations

import sys
import threading
import time as time_mod
from typing import Any, Dict, List, Optional

from pathway_tpu_torch.engine.columnar import Delta, StateTable
from pathway_tpu_torch.internals import parse_graph as pg


class GraphRunner:
    def __init__(self, graph: Any = None):
        self.graph = graph if graph is not None else pg.G
        self.states: Dict[int, StateTable] = {}
        self.evaluators: Dict[int, Any] = {}
        self.current_time = 0
        self._commit = 0
        self._sources: List[tuple] = []
        self._nodes: List[pg.Node] = []
        self._ready = False
        self._substep_deltas: Dict[int, Delta] = {}
        self._materialized: set = set()
        self.node_seconds: Dict[int, float] = {}
        self.commit_log: List[tuple] = []
        self._input_rows = 0
        self._stop = threading.Event()

    def state_of(self, node: pg.Node) -> StateTable:
        if node.id not in self._materialized:
            raise KeyError(
                f"state of node {node.id} ({node.kind}) was not materialized; "
                "the static reference analysis in _compute_materialized missed a "
                "consumer — please report"
            )
        return self.states[node.id]

    def _compute_materialized(self) -> set:
        """Node ids whose output state must be kept materialized: a node's
        StateTable is upkept only when something reads it (cross-table column
        references, ``ix`` targets). Everything else flows through as deltas."""
        all_ids = {n.id for n in self._nodes}
        needed: set = set()
        from pathway_tpu_torch.internals.expression import ColumnExpression

        def walk_value(value: Any, input_tables: list) -> None:
            if isinstance(value, ColumnExpression):
                for ref in value._column_refs:
                    if all(ref.table is not t for t in input_tables):
                        needed.add(ref.table._node.id)
            elif isinstance(value, dict):
                for v in value.values():
                    walk_value(v, input_tables)
            elif isinstance(value, (list, tuple)):
                for v in value:
                    walk_value(v, input_tables)

        def has_cross_ref(node: pg.Node) -> bool:
            found = [False]

            def walk(value: Any) -> None:
                if found[0]:
                    return
                if isinstance(value, ColumnExpression):
                    for ref in value._column_refs:
                        if all(ref.table is not t for t in node.inputs):
                            found[0] = True
                            return
                elif isinstance(value, dict):
                    for v in value.values():
                        walk(v)
                elif isinstance(value, (list, tuple)):
                    for v in value:
                        walk(v)

            walk(node.config)
            return found[0]

        for node in self._nodes:
            walk_value(node.config, list(node.inputs))
            if isinstance(node, pg.RowwiseNode) and has_cross_ref(node):
                # cross-table refs make this a LIVE dependency: the evaluator
                # re-derives affected rows from its input's state and suppresses
                # no-ops against its own output state — both must materialize
                needed.add(node.inputs[0]._node.id)
                needed.add(node.id)
            if isinstance(node, pg.IxNode):
                needed.add(node.inputs[1]._node.id)
        return needed & all_ids

    def current_delta_of(self, node: pg.Node) -> Optional[Delta]:
        """The delta ``node`` emitted in the current substep (None before it ran).
        Lets evaluators resolve retraction rows against retracted upstream values."""
        return self._substep_deltas.get(node.id)

    def setup(self) -> None:
        from pathway_tpu_torch.engine.evaluators import EVALUATORS

        self._nodes = list(self.graph.nodes)
        for node in self._nodes:
            if node.id in self.evaluators:
                continue
            evaluator_cls = EVALUATORS.get(type(node))
            if evaluator_cls is None:
                raise NotImplementedError(f"no evaluator for node kind {node.kind!r}")
            self.evaluators[node.id] = evaluator_cls(node, self)
            columns = node.output.column_names() if node.output is not None else []
            self.states[node.id] = StateTable(columns)
        self._sources = [
            (node, self.evaluators[node.id])
            for node in self._nodes
            if isinstance(node, pg.InputNode)
        ]
        self._materialized = self._compute_materialized()
        for node, _evaluator in self._sources:
            node.config["source"].on_start()
        self._ready = True

    def step(self) -> bool:
        """Run one commit; returns True if any node produced output."""
        t0 = time_mod.perf_counter()
        self.current_time = self._commit * 2  # even data times, as in the reference
        self._input_rows = 0
        any_output = self._substep()
        if any_output:
            self.commit_log.append((time_mod.perf_counter() - t0, self._input_rows))
        self._commit += 1
        return any_output

    def _substep(self) -> bool:
        deltas: Dict[int, Delta] = {}
        self._substep_deltas = deltas
        # sources first: a commit in which no source released rows moves
        # nothing (no operator of the port holds pending work), so the
        # operators are skipped — the idle loop wakes every autocommit tick
        if not any([self._run_node(node, deltas) for node, _ev in self._sources]):
            return False
        for node in self._nodes:
            if node.id not in deltas:
                self._run_node(node, deltas)
        return True

    def _run_node(self, node: pg.Node, deltas: Dict[int, Delta]) -> bool:
        """One operator's turn in the commit. Returns whether it emitted rows."""
        evaluator = self.evaluators[node.id]
        t0 = time_mod.perf_counter()
        if isinstance(node, pg.InputNode):
            delta = evaluator.process([])
            self._input_rows += len(delta)
        else:
            inputs = [
                deltas.get(inp._node.id, Delta.empty(inp.column_names()))
                for inp in node.inputs
            ]
            cross_nodes = getattr(evaluator, "_cross_nodes", None)
            if all(len(d) == 0 for d in inputs) and not (
                # a rowwise node's cross-table references are live deps:
                # run when any referenced table emitted this substep
                cross_nodes
                and any(len(deltas.get(n.id, ())) for n in cross_nodes)
            ):
                delta = Delta.empty(self.output_columns_of(node))
            else:
                delta = evaluator.process(inputs)
        self.node_seconds[node.id] = self.node_seconds.get(node.id, 0.0) + (
            time_mod.perf_counter() - t0
        )
        deltas[node.id] = delta
        if not len(delta):
            return False
        if node.output is not None and node.id in self._materialized:
            self.states[node.id].apply(delta)
        return True

    def output_columns_of(self, node: pg.Node) -> List[str]:
        return node.output.column_names() if node.output is not None else []

    def sources_finished(self) -> bool:
        return all(node.config["source"].is_finished() for node, _ in self._sources)

    def subtree_closed(self, node: pg.Node) -> bool:
        """True when ``node``'s operator subtree can emit no further delta in
        any future commit (every ancestor source finished). Joins use it to
        stop arranging a side that can never be probed again."""
        cache = getattr(self, "_closed_cache", None)
        if cache is None or cache[0] != self._commit:
            cache = (self._commit, {})
            self._closed_cache = cache
        memo = cache[1]
        if node.id in memo:
            return memo[node.id]
        memo[node.id] = False  # cycle guard
        if isinstance(node, pg.InputNode):
            closed = node.config["source"].is_finished()
        else:
            closed = all(self.subtree_closed(inp._node) for inp in node.inputs)
        memo[node.id] = closed
        return closed

    def _ancestor_inputs(self, node: pg.Node) -> list:
        """Transitive InputNodes feeding ``node`` (memoized)."""
        cache = getattr(self, "_ancestor_cache", None)
        if cache is None:
            cache = self._ancestor_cache = {}
        if node.id in cache:
            return cache[node.id]
        cache[node.id] = []  # cycle guard
        out: list = []
        if isinstance(node, pg.InputNode):
            out.append(node)
        for inp in node.inputs:
            out.extend(self._ancestor_inputs(inp._node))
        cache[node.id] = out
        return out

    def _notify_stream_end(self) -> None:
        """Deliver on_end to each subscriber whose entire input ancestry is final."""
        from pathway_tpu_torch.engine.evaluators import OutputEvaluator

        for node in self._nodes:
            evaluator = self.evaluators.get(node.id)
            if isinstance(evaluator, OutputEvaluator) and all(
                a.config["source"].is_finished() for a in self._ancestor_inputs(node)
            ):
                evaluator.notify_stream_end()

    def finish(self) -> None:
        from pathway_tpu_torch.engine.evaluators import OutputEvaluator

        for node in self._nodes:
            evaluator = self.evaluators.get(node.id)
            if isinstance(evaluator, OutputEvaluator):
                evaluator.finish()
        # no thread that owns the card outlives the run: drain and join the
        # encoder services' workers (they respawn on the next submit); a
        # module never imported has no services
        svc_mod = sys.modules.get("pathway_tpu_torch.models.encoder_service")
        if svc_mod is not None:
            svc_mod.stop_all_workers()

    def stop(self) -> None:
        """Ask a running :meth:`run` to return after its current commit."""
        self._stop.set()
        from pathway_tpu_torch.engine.datasource import StreamingDataSource

        StreamingDataSource._wake_all()

    def run(
        self,
        *,
        terminate_on_error: bool = True,
        max_commits: int | None = None,
        device: Any = None,
        **kwargs: Any,
    ) -> None:
        """Commit until every source is finished and drained (or :meth:`stop`).

        ``device``: where the engine offloads device work (large float sums);
        the card unless ``"cpu"``."""
        if not self._ready:
            self.setup()
        from pathway_tpu_torch.engine import expression_evaluator as ee_mod

        runtime = ee_mod.get_runtime()
        prev_runtime = dict(runtime)
        runtime["terminate_on_error"] = terminate_on_error
        runtime["device"] = device
        from pathway_tpu_torch.engine.datasource import StreamingDataSource

        wake = threading.Event()
        StreamingDataSource.register_runner(wake)
        commits = 0
        try:
            while not self._stop.is_set():
                wake.clear()
                any_output = self.step()
                commits += 1
                if max_commits is not None and commits >= max_commits:
                    break
                if self.sources_finished() and not any_output:
                    self._notify_stream_end()
                    break
                if not any_output:
                    # idle: sleep until a producer pushes, or until a source's
                    # autocommit window releases what it holds
                    now = time_mod.monotonic()
                    hints = [
                        h for node, _ev in self._sources
                        if (h := node.config["source"].wait_hint(now)) is not None
                    ]
                    wake.wait(timeout=min(hints) if hints else None)
        finally:
            StreamingDataSource.unregister_runner(wake)
            runtime.update(prev_runtime)
            if max_commits is None:
                self.finish()


def run(**kwargs: Any) -> None:
    """Execute the global dataflow graph (``pw.run``)."""
    GraphRunner(pg.G).run(**kwargs)


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
