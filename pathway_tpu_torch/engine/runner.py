"""The commit loop (port of ``pathway_tpu/engine/runner.py``, single process).

Each commit gathers one batch per source, pushes deltas through the operator
DAG in topological order and delivers outputs. A commit runs in two phases,
as the reference's does: the alt phase at the even time ``2 * commit`` moves
the data, and the neu phase at ``2 * commit + 1`` runs only when a
time-threshold operator has forgetting retractions to drain. The port runs
one process with operator fusion off; persistence, checkpoints, cluster
routing, membership, tracing and the lint gate are not ported.

The metrics plane is the reference's: with ``PATHWAY_PROFILE`` on (the
default) every operator turn appends ``(node_id, name, kind, seconds, rows,
retractions, neu)`` to the commit's profile, which feeds the process-wide
``EngineProfiler`` and the flight recorder; ``ProberStats`` counts rows and
commits for ``/metrics`` (``run(with_http_server=True)``), and a run that
raises dumps the flight recorder as ``crash: <ExcType>`` when a dump
directory is known. The last ``COMMIT_LOG_LEN`` commits that moved rows are
logged as (seconds, input rows) in :attr:`GraphRunner.commit_log`.

``pw.iterate`` runs its body in a nested runner (``_materialize_all``): it
keeps every node's state, and it attaches no profiler, flight recorder,
monitor or HTTP server, so the metrics plane sees the outer operators only.
"""

from __future__ import annotations

import collections
import sys
import threading
import time as time_mod
from typing import Any, Dict, List, Optional

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta, StateTable
from pathway_tpu_torch.engine.profile import CommitProfile
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.trace import add_error_context

#: commits kept in :attr:`GraphRunner.commit_log` (a server's log must not
#: grow for its whole life)
COMMIT_LOG_LEN = 4096


class GraphRunner:
    def __init__(self, graph: Any = None):
        self.graph = graph if graph is not None else pg.G
        # a nested iterate runner: every state kept, no metrics plane
        self._materialize_all = False
        self.states: Dict[int, StateTable] = {}
        self.evaluators: Dict[int, Any] = {}
        self.current_time = 0
        self._commit = 0
        self._sources: List[tuple] = []
        self._logs: Dict[int, Any] = {}
        self._nodes: List[pg.Node] = []
        self._ready = False
        self._substep_deltas: Dict[int, Delta] = {}
        self._materialized: set = set()
        # the sources finished before this commit began: buffers flush
        self.draining = False
        # ids of the nodes whose evaluator holds rows between commits (kept
        # after each operator's turn): a commit in which no source released
        # rows skips the operators only while it is empty
        self._pending: set = set()
        self.commit_log: "collections.deque[tuple]" = collections.deque(maxlen=COMMIT_LOG_LEN)
        self._input_rows = 0
        self._stop = threading.Event()
        # the metrics plane (bound in setup / run)
        self._profiler: Any = None
        self._recorder: Any = None
        self._profile_ops: "List[tuple] | None" = None
        self._idle_ops: List[tuple] = []
        self._monitor: Any = None
        self._metrics: Any = None
        self._http_server: Any = None
        self.prober_stats: Any = None
        self._step_counts: Dict[int, int] = {}
        self._output_rows_this_commit = 0
        # the running thread's runtime dict (expression_evaluator.get_runtime)
        self._runtime: Dict[str, Any] = {}

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
        if self._materialize_all:
            return all_ids
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

    def setup(self, monitoring_level: Any = None) -> None:
        from pathway_tpu_torch.engine import profile as _profile
        from pathway_tpu_torch.engine.evaluators import EVALUATORS
        from pathway_tpu_torch.internals.config import get_pathway_config

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
        # error logs, which run in their place among the operators
        self._logs = {
            node.id: node.config["source"]
            for node, _evaluator in self._sources
            if getattr(node.config["source"], "drains_in_place", False)
        }
        self._materialized = self._compute_materialized()
        for node, _evaluator in self._sources:
            node.config["source"].on_start()
        if self._materialize_all:
            self._ready = True
            return
        if _profile.profiling_enabled():
            self._profiler = _profile.get_profiler()
            # a commit in which no source released rows skips the operators:
            # each still gets its turn in the profile, at zero seconds, as
            # the reference's idle operator turns do
            self._idle_ops = [
                (node.id, node.name, node.kind, 0.0, 0, 0, False)
                for node in self._nodes
                if not isinstance(node, pg.InputNode)
            ]
        self._recorder = _profile.get_flight_recorder()
        # one process, no supervisor: dumps go to PATHWAY_FLIGHT_RECORDER_DIR
        self._recorder.configure(rank=get_pathway_config().process_id, default_dir=None)
        self._monitor = _make_monitor(monitoring_level, self._nodes)
        self._ready = True

    def step(self) -> bool:
        """Run one commit; returns True if any node produced output.

        The alt phase moves the data. When an evaluator then has forgetting
        retractions to drain (``neu_pending``), the neu phase runs at the odd
        time ``2 * commit + 1`` and its deltas carry ``neu=True``, so a delta
        is never a mix of data and forgetting and
        ``_filter_out_results_of_forgetting`` can drop whole neu deltas."""
        commit_t0 = time_mod.monotonic()
        self.current_time = self._commit * 2  # even data times, as in the reference
        self.draining = self._ready and self.sources_finished()
        self._input_rows = 0
        self._step_counts = {}
        self._output_rows_this_commit = 0
        self._profile_ops = [] if self._profiler is not None else None
        any_output = self._substep(neu=False)
        neu = any(self.evaluators[node_id].neu_pending() for node_id in self._pending)
        if neu:
            self.current_time = self._commit * 2 + 1
            any_output = self._substep(neu=True) or any_output
        duration_s = time_mod.monotonic() - commit_t0
        if any_output:
            self.commit_log.append((duration_s, self._input_rows))
        if self.prober_stats is not None:
            self.prober_stats.record_commit(
                self._input_rows,
                self._output_rows_this_commit,
                self._step_counts,
                self.sources_finished(),
            )
            if self._metrics is not None:
                self._metrics.record_commit(
                    self._input_rows, self._output_rows_this_commit, duration_s
                )
        if self._profiler is not None:
            commit_profile = CommitProfile(
                commit=self._commit,
                rank=self._recorder.rank,
                duration_s=duration_s,
                input_rows=self._input_rows,
                output_rows=self._output_rows_this_commit,
                neu=neu,
                ops=self._profile_ops or [],
            )
            self._profiler.record_commit(commit_profile)
            self._recorder.record_commit(commit_profile)
            self._profile_ops = None
        if self._monitor is not None:
            self._monitor.update(self._commit, self._step_counts, self.states)
        self._commit += 1
        return any_output

    def _substep(self, *, neu: bool) -> bool:
        deltas: Dict[int, Delta] = {}
        self._substep_deltas = deltas
        # sources first: a commit in which no source released rows and no
        # operator holds rows moves nothing, so the operators are skipped
        # (the idle loop wakes every autocommit tick). An error log drains in
        # its place in the node order, as in the reference: errors of the
        # operators before it reach it in the same commit.
        released = any([
            self._run_node(node, deltas, neu)
            for node, _ev in self._sources
            if node.id not in self._logs
        ])
        if (
            not released
            and not self._pending
            and not any(self._logs[node_id].pending for node_id in self._logs)
        ):
            if self._profile_ops is not None:
                self._profile_ops.extend(self._idle_ops)
            return False
        any_output = released
        for node in self._nodes:
            if node.id not in deltas and self._run_node(node, deltas, neu):
                any_output = True
        return any_output

    def _run_node(self, node: pg.Node, deltas: Dict[int, Delta], neu: bool) -> bool:
        """One operator's turn in a phase of the commit. Returns whether it
        emitted rows."""
        evaluator = self.evaluators[node.id]
        # the operator whose UDF errors go to its error log
        self._runtime["node"] = node
        # commit identity for UDFs that read live process-global state (the
        # /v1/statistics engine snapshot): re-derivations within one commit
        # see the same value, the next commit reads fresh
        self._runtime["commit_token"] = (id(self), self._commit)
        t0 = time_mod.perf_counter()
        if isinstance(node, pg.OutputNode) and not neu:
            # rows delivered to sinks (not the forgetting phase's retractions)
            self._output_rows_this_commit += sum(
                len(deltas.get(inp._node.id, ())) for inp in node.inputs
            )
        if isinstance(node, pg.InputNode):
            if neu:
                delta = Delta.empty(self.output_columns_of(node))
            else:
                delta = evaluator.process([])
                self._input_rows += len(delta)
        else:
            inputs = [
                deltas.get(inp._node.id, Delta.empty(inp.column_names()))
                for inp in node.inputs
            ]
            holds = node.id in self._pending
            originates = neu and holds and evaluator.neu_pending()
            cross_nodes = getattr(evaluator, "_cross_nodes", None)
            if (
                all(len(d) == 0 for d in inputs)
                and not originates
                # an operator holding rows runs in every alt phase: ``now``
                # may have passed a threshold, or the stream is draining
                and not (holds and not neu)
                # an iterate's or a row transformer's further results
                # arrive beside its first
                and node.kind not in ("iterate_result", "row_transformer_result")
                and not (
                    # a rowwise node's cross-table references are live deps:
                    # run when any referenced table emitted this substep
                    cross_nodes
                    and any(len(deltas.get(n.id, ())) for n in cross_nodes)
                )
            ):
                delta = Delta.empty(self.output_columns_of(node))
            else:
                if originates:
                    delta = evaluator.drain_neu(inputs)
                else:
                    try:
                        delta = evaluator.process(inputs)
                    except Exception as exc:
                        # name the user line that built the failing operator
                        raise add_error_context(exc, node) from exc
                if evaluator.has_pending():
                    self._pending.add(node.id)
                elif holds:
                    self._pending.discard(node.id)
            if neu and len(delta):
                delta.neu = True
        deltas[node.id] = delta
        rows = len(delta)
        if rows:
            self._step_counts[node.id] = self._step_counts.get(node.id, 0) + rows
            if node.output is not None and node.id in self._materialized:
                self.states[node.id].apply(delta)
        if self._profile_ops is not None:
            self._profile_ops.append((
                node.id,
                node.name,
                node.kind,
                time_mod.perf_counter() - t0,
                rows,
                int(np.count_nonzero(delta.diffs < 0)) if rows else 0,
                neu,
            ))
        return rows > 0

    def output_columns_of(self, node: pg.Node) -> List[str]:
        return node.output.column_names() if node.output is not None else []

    def sources_finished(self) -> bool:
        return all(node.config["source"].is_finished() for node, _ in self._sources)

    def primary_sources_finished(self) -> bool:
        """Every source but the loop-backs is finished (a loop-back closes
        only once the subscribers that feed it heard the end)."""
        return all(
            node.config["source"].is_finished()
            for node, _ in self._sources
            if not getattr(node.config["source"], "loopback", False)
        )

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
        elif node.id in self._pending:
            closed = False  # an operator holding rows can still emit them
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
        """Deliver on_end to each subscriber whose entire input ancestry is
        final, loop-back sources included: a subscriber below an
        AsyncTransformer hears it only after the last invocation, and a
        chained transformer closes in cascade. Re-checked on every idle
        commit; each subscriber hears it once."""
        from pathway_tpu_torch.engine.evaluators import OutputEvaluator

        for node in self._nodes:
            evaluator = self.evaluators.get(node.id)
            if isinstance(evaluator, OutputEvaluator) and all(
                a.config["source"].is_finished() for a in self._ancestor_inputs(node)
            ):
                evaluator.notify_stream_end()

    def finish(self) -> None:
        from pathway_tpu_torch.engine.evaluators import (
            OutputEvaluator,
            WithUniverseOfEvaluator,
        )

        for node in self._nodes:
            evaluator = self.evaluators.get(node.id)
            if isinstance(evaluator, OutputEvaluator):
                evaluator.finish()
            elif isinstance(evaluator, WithUniverseOfEvaluator):
                evaluator.verify_universes()
        if self._monitor is not None:
            self._monitor.close()
        self._close_http_server()
        # no thread that owns the card outlives the run: drain and join the
        # encoder services' workers (they respawn on the next submit); a
        # module never imported has no services
        svc_mod = sys.modules.get("pathway_tpu_torch.models.encoder_service")
        if svc_mod is not None:
            svc_mod.stop_all_workers()

    def _close_http_server(self) -> None:
        if self._http_server is not None:
            self._http_server.close()
            self._http_server = None

    def stop(self) -> None:
        """Ask a running :meth:`run` to return after its current commit."""
        self._stop.set()
        from pathway_tpu_torch.engine.datasource import StreamingDataSource

        StreamingDataSource._wake_all()

    def has_pending(self) -> bool:
        """Whether an operator holds rows that a later commit may emit."""
        return bool(self._pending)

    def run(
        self,
        *,
        terminate_on_error: bool = True,
        max_commits: int | None = None,
        device: Any = None,
        monitoring_level: Any = None,
        with_http_server: bool = False,
        **kwargs: Any,
    ) -> None:
        """Commit until every source, loop-backs included, is finished and
        drained and no operator holds rows (or :meth:`stop`).

        ``device``: where the engine offloads device work (large float sums);
        the card unless ``"cpu"``. ``with_http_server``: serve ``/metrics``,
        ``/status`` and ``/healthz`` on ``PATHWAY_MONITORING_HTTP_PORT``
        (default 20000) + process id while the run lasts.
        ``monitoring_level``: a :class:`MonitoringLevel` for the terminal
        dashboard (None: off)."""
        from pathway_tpu_torch.engine import expression_evaluator as ee_mod
        from pathway_tpu_torch.engine.http_server import ProberStats, maybe_start_http_server
        from pathway_tpu_torch.engine.telemetry import MetricsRecorder, span

        self.prober_stats = ProberStats()
        self._http_server = maybe_start_http_server(self.prober_stats, with_http_server)
        self._metrics = MetricsRecorder.get(self.prober_stats)
        try:
            if not self._ready:
                with span("graph_runner.build", nodes=len(self.graph.nodes)):
                    self.setup(monitoring_level)
        except BaseException:
            self._close_http_server()
            raise
        runtime = self._runtime = ee_mod.get_runtime()
        prev_runtime = dict(runtime)
        runtime["terminate_on_error"] = terminate_on_error
        runtime["device"] = device
        # the error log of operators without a local one; nested iterate
        # runners run on this thread and inherit it
        runtime["global_source"] = getattr(self.graph, "_error_log_source", None)
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
                finished = self.sources_finished()
                idle = not any_output and not self._pending
                if idle and self.primary_sources_finished():
                    self._notify_stream_end()
                if finished and idle:
                    break
                if not any_output and not finished:
                    # idle: sleep until a producer pushes, or until a source's
                    # autocommit window releases what it holds
                    now = time_mod.monotonic()
                    hints = [
                        h for node, _ev in self._sources
                        if (h := node.config["source"].wait_hint(now)) is not None
                    ]
                    wake.wait(timeout=min(hints) if hints else None)
        except BaseException as exc:
            if self._recorder is not None:
                self._recorder.dump(f"crash: {type(exc).__name__}")
            raise
        finally:
            StreamingDataSource.unregister_runner(wake)
            runtime.update(prev_runtime)
            if max_commits is None:
                self.finish()
            else:
                # stepped runs keep engine state but must not leak the
                # monitoring listener port across back-to-back runs
                self._close_http_server()


def _make_monitor(level: Any, nodes: List[pg.Node]) -> Any:
    if level is None:
        return None
    from pathway_tpu_torch.internals.monitoring import MonitoringLevel, StatsMonitor

    if level in (MonitoringLevel.NONE, "none"):
        return None
    if isinstance(level, str):
        level = MonitoringLevel(level)
    return StatsMonitor(nodes, level=level)


def run(
    *,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    **kwargs: Any,
) -> None:
    """Execute the global dataflow graph (``pw.run``)."""
    GraphRunner(pg.G).run(
        monitoring_level=monitoring_level, with_http_server=with_http_server, **kwargs
    )


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
