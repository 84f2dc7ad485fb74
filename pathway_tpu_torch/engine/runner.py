"""The commit loop (port of ``pathway_tpu/engine/runner.py``, single process).

Each commit gathers one batch per source, pushes deltas through the operator
DAG in topological order and delivers outputs. A commit runs in two phases,
as the reference's does: the alt phase at the even time ``2 * commit`` moves
the data, and the neu phase at ``2 * commit + 1`` runs only when a
time-threshold operator has forgetting retractions to drain. The port runs
one process with operator fusion off; cluster routing, membership, the undo
ring, tracing and the lint gate are not ported.

Persistence (``run(persistence_config=...)`` or ``PATHWAY_REPLAY_STORAGE``)
is the reference's single-process path: each commit that moved input rows or
closed a segment appends a journal frame (its input deltas and every source's
offsets); a run over the same store first loads the checkpoint, if any, and
puts the sources back where the journal left them, then replays the journal's
frames through the graph (``persistence_mode="batch"``: as one commit;
``"silent_replay"``: without delivering to sinks) and goes on from there.
``snapshot_interval_ms > 0`` checkpoints operator state and compacts the
journal, unless an operator cannot be pickled or holds state outside the
snapshot protocol (an external index): such a graph resumes by replaying
the whole journal. :attr:`GraphRunner.persist_stats` counts the frames,
bytes and host seconds of the journal and of the replay. A chaos plan
(``PATHWAY_CHAOS_PLAN``, ``internals/chaos.py``) may SIGKILL the process at
the start of a named live commit; the journal's replay never fires a kill.

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
        # persistence (bound in setup)
        self._persistence: Any = None
        self._inject: Optional[Dict[int, Delta]] = None  # the journal's replay
        self._input_deltas: Dict[int, Delta] = {}
        self._replay_frames: List[tuple] = []
        self._graph_sig = ""
        self._snapshot_interval_s = 0.0
        self._last_checkpoint = time_mod.monotonic()
        self._warned_unpicklable = False
        # silent_replay: sinks do not hear the replayed history again
        self.replay_outputs = True
        self.persist_stats: Dict[str, float] = {}
        # fault injection (``internals/chaos.py``; bound in setup, None
        # without a plan)
        self._chaos: Any = None
        self._rank = 0

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
        if self._materialize_all or self._persistence is not None:
            # a checkpoint snapshots every state
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

    def setup(self, monitoring_level: Any = None, persistence_config: Any = None) -> None:
        from pathway_tpu_torch.engine import profile as _profile
        from pathway_tpu_torch.engine.evaluators import EVALUATORS
        from pathway_tpu_torch.internals.chaos import get_chaos
        from pathway_tpu_torch.internals.config import get_pathway_config

        self._chaos = None if self._materialize_all else get_chaos()
        self._rank = get_pathway_config().process_id
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
        if persistence_config is not None and persistence_config.backend is not None:
            self._open_persistence(persistence_config)
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

    # -- persistence -------------------------------------------------------------

    def _open_persistence(self, config: Any) -> None:
        """Open the store, restore the checkpoint and the sources' positions,
        and keep the journal's frames after the checkpoint for the replay."""
        from pathway_tpu_torch.persistence.engine import PersistenceManager

        self._persistence = PersistenceManager(config)
        self.replay_outputs = config.persistence_mode != "silent_replay"
        sig = self._graph_sig = self.graph.sig()
        self._snapshot_interval_s = (getattr(config, "snapshot_interval_ms", 0) or 0) / 1000.0
        self.persist_stats = {
            "frames": 0, "journal_bytes": 0, "record_s": 0.0, "checkpoints": 0,
            "replay_frames": 0, "replay_rows": 0, "replay_s": 0.0,
        }
        checkpoint = self._persistence.load_checkpoint(sig)
        frames = self._persistence.load_journal(sig)
        self._persistence.open_for_append(sig)
        restore_frames = list(frames)
        if checkpoint is not None:
            base_commit, blob = checkpoint
            self._load_checkpoint_state(blob)
            self._commit = base_commit + 1
            # frames up to the checkpoint are subsumed by it (a crash may have
            # come between the checkpoint and the journal's compaction)
            frames = [f for f in frames if f[0] > base_commit]
            offsets, deltas = blob["source_offsets"], blob["source_deltas"]
            synthetic = (
                base_commit,
                {},
                {
                    nid: {
                        **offsets.get(nid, {}),
                        **({"state_deltas": deltas[nid]} if deltas.get(nid) else {}),
                    }
                    for nid in set(offsets) | set(deltas)
                },
            )
            restore_frames = [synthetic, *frames]
        if restore_frames:
            self._restore_sources(restore_frames)
        self._replay_frames = frames

    def _replay(self) -> None:
        """Feed the journal's frames through the (deterministic) graph,
        before any live commit."""
        from pathway_tpu_torch.internals.config import get_pathway_config

        frames, self._replay_frames = self._replay_frames, []
        if not frames:
            return
        t0 = time_mod.perf_counter()
        self.persist_stats["replay_frames"] = len(frames)
        self.persist_stats["replay_rows"] = sum(
            len(d) for _cid, deltas, _offs in frames for d in deltas.values()
        )
        if get_pathway_config().persistence_mode == "batch":
            # the whole recording as one commit
            merged: Dict[int, List[Delta]] = {}
            for _cid, input_deltas, _offs in frames:
                for nid, delta in input_deltas.items():
                    merged.setdefault(nid, []).append(delta)
            combined = {nid: Delta.concat(ds, list(ds[0].columns)) for nid, ds in merged.items()}
            frames = [(frames[-1][0], combined, frames[-1][2])]
        try:
            for _commit_id, input_deltas, _offsets in frames:
                self._inject = input_deltas
                self.step()
        finally:
            self._inject = None
        # later frame ids exceed every journaled id (a checkpoint subsumes
        # frames by id)
        self._commit = max(self._commit, frames[-1][0] + 1)
        self.persist_stats["replay_s"] = time_mod.perf_counter() - t0

    def _restore_sources(self, frames: List[tuple]) -> None:
        """Fold the journaled segment-state deltas and the unmarked tail back
        into each source."""
        from pathway_tpu_torch.internals.keys import keys_to_pointers

        last_offsets = frames[-1][2]
        for node, _ in self._sources:
            nid = node.id
            offsets = last_offsets.get(nid, {})
            rehydrate = getattr(
                getattr(node.config["source"], "subject", None), "rehydrate_state_deltas", None
            )
            # a journal frame's markers are slim: their rows come back from
            # the input deltas journaled up to the marker's frame (row keys
            # are derived from content, so the lookup is exact)
            row_values: Dict[bytes, Any] = {}
            fed_until = 0

            def feed_rows(up_to: int) -> None:
                nonlocal fed_until
                for f_idx in range(fed_until, up_to):
                    delta = frames[f_idx][1].get(nid)
                    if delta is None or len(delta) == 0:
                        continue
                    for i in np.nonzero(delta.diffs > 0)[0].tolist():
                        row_values[delta.keys[i].tobytes()] = {
                            n: c[i] for n, c in delta.columns.items()
                        }
                fed_until = max(fed_until, up_to)

            state_deltas: List[Any] = []
            last_marker_idx = -1
            for idx, (_cid, _deltas, offs) in enumerate(frames):
                deltas = offs.get(nid, {}).get("state_deltas")
                if deltas:
                    if rehydrate is not None and any(
                        "rows" not in d and not d.get("deleted") for d in deltas
                    ):
                        feed_rows(idx + 1)
                        deltas = rehydrate(deltas, row_values)
                    state_deltas.extend(deltas)
                    last_marker_idx = idx
            tail: Optional[dict] = None
            if offsets.get("consumed", 0) > 0 or offsets.get("done"):
                tail_rows: List[tuple] = []
                for _cid, input_deltas, _offs in frames[last_marker_idx + 1:]:
                    delta = input_deltas.get(nid)
                    if delta is None or len(delta) == 0:
                        continue
                    pointers = keys_to_pointers(delta.keys)
                    for i in range(len(delta)):
                        values = {n: c[i] for n, c in delta.columns.items()}
                        tail_rows.append((pointers[i], values, int(delta.diffs[i])))
                in_progress = offsets.get("in_progress") or {}
                covered = 0
                if last_marker_idx >= 0:
                    covered = frames[last_marker_idx][2].get(nid, {}).get("consumed", 0)
                tail = {
                    "token": in_progress.get("token"),
                    "fp": in_progress.get("fp"),
                    "count": in_progress.get("emitted", 0),
                    "rows": tail_rows,
                    # events up to ``covered`` are accounted for by markers;
                    # only a subject without markers pushes its history again
                    "covered": covered,
                    "has_markers": last_marker_idx >= 0,
                }
            node.config["source"].restore(offsets, state_deltas, tail)

    def _load_checkpoint_state(self, blob: dict) -> None:
        """Restore the state tables and operators of a checkpoint; live sinks
        then get the restored state as one delivery (they cannot hear the
        compacted history)."""
        for nid, sblob in blob["states"].items():
            if nid in self.states:
                self.states[nid].load_state_blob(sblob)
        for nid, estate in blob["evaluators"].items():
            evaluator = self.evaluators.get(nid)
            if evaluator is not None:
                evaluator.load_state_dict(estate)
        self._deliver_sink_snapshots()

    def _deliver_sink_snapshots(self) -> None:
        from pathway_tpu_torch.engine.evaluators import OutputEvaluator

        if not self.replay_outputs:
            return
        for node in self._nodes:
            evaluator = self.evaluators[node.id]
            if isinstance(evaluator, OutputEvaluator):
                snapshot = self.states[node.inputs[0]._node.id].snapshot()
                if len(snapshot):
                    evaluator.process([snapshot])

    def _snapshot_blob(self) -> "tuple[dict | None, str]":
        """The whole engine snapshot (operator, state-table and source state):
        ``(blob, "ok")``; ``(None, "defer")`` while a source is inside a
        segment (its events before the checkpoint would be baked into state
        while its tail stays in the journal, and a changed segment could not
        be undone); ``(None, "permanent: ...")`` where an operator cannot be
        snapshotted."""
        from pathway_tpu_torch.engine.evaluators import (
            InputEvaluator,
            OutputEvaluator,
            UnpicklableStateError,
        )

        offsets = {
            # a frame's own markers do not belong in the checkpoint
            n.id: {k: v for k, v in n.config["source"].offset_state().items() if k != "state_deltas"}
            for n, _ in self._sources
        }
        if any(o.get("in_progress") for o in offsets.values()):
            return None, "defer"
        outside = sorted(
            {
                type(ev).__name__
                for ev in self.evaluators.values()
                # iterate's evaluators have no snapshot protocol
                if not getattr(ev, "SNAPSHOT_CAPTURE", False)
            }
        )
        if outside:
            return None, f"permanent: {', '.join(outside)} holds state outside the snapshot protocol"
        deltas = {n.id: n.config["source"].checkpoint_state_deltas() for n, _ in self._sources}
        try:
            blob = {
                "states": {nid: st.state_blob() for nid, st in self.states.items()},
                "evaluators": {
                    nid: ev.state_dict()
                    for nid, ev in self.evaluators.items()
                    if not isinstance(ev, (InputEvaluator, OutputEvaluator))
                },
                "source_offsets": offsets,
                "source_deltas": deltas,
            }
        except UnpicklableStateError as exc:
            return None, f"permanent: {exc}"
        return blob, "ok"

    def _take_checkpoint(self) -> bool:
        """Snapshot, then compact the journal."""
        blob, why = self._snapshot_blob()
        if blob is None:
            if why.startswith("permanent"):
                if not self._warned_unpicklable:
                    self._warned_unpicklable = True
                    import logging

                    logging.getLogger("pathway_tpu_torch").warning(
                        "operator checkpointing disabled: %s — falling back to "
                        "full journal replay on resume",
                        why,
                    )
                self._snapshot_interval_s = 0.0  # do not try again every commit
            return False
        self._persistence.dump_checkpoint(self._graph_sig, self._commit, blob)
        self.persist_stats["checkpoints"] += 1
        return True

    def _journal_commit(self) -> None:
        """Append this commit's frame (when it moved input rows or closed a
        segment), then checkpoint when one is due."""
        offsets = {n.id: n.config["source"].offset_state() for n, _ in self._sources}
        if not any(len(d) for d in self._input_deltas.values()) and not any(
            o.get("state_deltas") for o in offsets.values()
        ):
            return
        t0 = time_mod.perf_counter()
        size = self._persistence.record_commit(self._commit, self._input_deltas, offsets)
        stats = self.persist_stats
        stats["record_s"] += time_mod.perf_counter() - t0
        stats["frames"] += 1
        stats["journal_bytes"] += size
        if (
            self._snapshot_interval_s > 0
            and time_mod.monotonic() - self._last_checkpoint >= self._snapshot_interval_s
            and self._take_checkpoint()
        ):
            self._last_checkpoint = time_mod.monotonic()

    def step(self) -> bool:
        """Run one commit; returns True if any node produced output.

        The alt phase moves the data. When an evaluator then has forgetting
        retractions to drain (``neu_pending``), the neu phase runs at the odd
        time ``2 * commit + 1`` and its deltas carry ``neu=True``, so a delta
        is never a mix of data and forgetting and
        ``_filter_out_results_of_forgetting`` can drop whole neu deltas."""
        commit_t0 = time_mod.monotonic()
        if self._chaos is not None and self._inject is None:
            # a scheduled kill fires at a live commit boundary, before the
            # commit runs: the journal holds every commit before it. The
            # journal's replay never fires one, or a resume would loop
            self._chaos.maybe_kill(self._rank, self._commit)
        self.current_time = self._commit * 2  # even data times, as in the reference
        self.draining = self._ready and self.sources_finished()
        self._input_rows = 0
        self._input_deltas = {}
        self._step_counts = {}
        self._output_rows_this_commit = 0
        self._profile_ops = [] if self._profiler is not None else None
        any_output = self._substep(neu=False)
        neu = any(self.evaluators[node_id].neu_pending() for node_id in self._pending)
        if neu:
            self.current_time = self._commit * 2 + 1
            any_output = self._substep(neu=True) or any_output
        if self._persistence is not None and self._inject is None:
            self._journal_commit()
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
                if self._inject is not None:
                    # the journal's replay: the journaled delta, not the source's
                    delta = self._inject.get(node.id, Delta.empty(self.output_columns_of(node)))
                    if node.id in self._logs:
                        # the replayed operators' errors are journaled already
                        self._logs[node.id].pending.clear()
                else:
                    delta = evaluator.process([])
                self._input_rows += len(delta)
                self._input_deltas[node.id] = delta
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
        stop arranging a side that can never be probed again. Never under
        persistence or in the journal's replay: a checkpoint snapshots every
        arrangement, and a replayed source's end is not the stream's."""
        if self._persistence is not None or self._inject is not None:
            return False
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

        for node, _ in self._sources:
            # graceful producer shutdown: a subject parked on its producer
            # (an importer whose exporter never closes) returns
            subject = getattr(node.config["source"], "subject", None)
            stop = getattr(subject, "stop", None)
            if stop is not None:
                stop()
        for node in self._nodes:
            evaluator = self.evaluators.get(node.id)
            if isinstance(evaluator, OutputEvaluator):
                evaluator.finish()
            elif isinstance(evaluator, WithUniverseOfEvaluator):
                evaluator.verify_universes()
        if self._persistence is not None:
            self._persistence.close()
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
        persistence_config: Any = None,
        **kwargs: Any,
    ) -> None:
        """Commit until every source, loop-backs included, is finished and
        drained and no operator holds rows (or :meth:`stop`).

        ``device``: where the engine offloads device work (large float sums);
        the card unless ``"cpu"``. ``with_http_server``: serve ``/metrics``,
        ``/status`` and ``/healthz`` on ``PATHWAY_MONITORING_HTTP_PORT``
        (default 20000) + process id while the run lasts.
        ``monitoring_level``: a :class:`MonitoringLevel` for the terminal
        dashboard (None: off). ``persistence_config``: a
        ``pw.persistence.Config``; without one, ``PATHWAY_REPLAY_STORAGE``
        names a filesystem store."""
        from pathway_tpu_torch.engine import expression_evaluator as ee_mod
        from pathway_tpu_torch.engine.http_server import ProberStats, maybe_start_http_server
        from pathway_tpu_torch.engine.telemetry import MetricsRecorder, span
        from pathway_tpu_torch.internals.config import get_pathway_config

        env_cfg = get_pathway_config()
        if persistence_config is None and env_cfg.replay_storage:
            # the record / replay contract of ``pathway spawn --record``
            from pathway_tpu_torch import persistence

            persistence_config = persistence.Config(
                persistence.Backend.filesystem(env_cfg.replay_storage)
            )
        self.prober_stats = ProberStats()
        self._http_server = maybe_start_http_server(self.prober_stats, with_http_server)
        self._metrics = MetricsRecorder.get(self.prober_stats)
        try:
            if not self._ready:
                with span("graph_runner.build", nodes=len(self.graph.nodes)):
                    self.setup(monitoring_level, persistence_config=persistence_config)
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
            self._replay()
            # a replay-only run (``pathway replay`` without ``--continue``)
            # stops once the journal went through the graph
            replay_only = (
                env_cfg.snapshot_access == "replay" and not env_cfg.continue_after_replay
            )
            while not self._stop.is_set() and not replay_only:
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
            # a failing run must be distinguishable from a clean close by sinks
            # that hand state to other graphs (ExportedTable._fail); finish()
            # in the finally block fires their on_end either way
            from pathway_tpu_torch.engine.evaluators import OutputEvaluator

            if self._recorder is not None:
                self._recorder.dump(f"crash: {type(exc).__name__}")
            for evaluator in self.evaluators.values():
                if isinstance(evaluator, OutputEvaluator):
                    evaluator.notify_failure(exc)
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
    persistence_config: Any = None,
    **kwargs: Any,
) -> None:
    """Execute the global dataflow graph (``pw.run``)."""
    GraphRunner(pg.G).run(
        monitoring_level=monitoring_level,
        with_http_server=with_http_server,
        persistence_config=persistence_config,
        **kwargs,
    )


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
