"""Deterministic fault injection (port of ``pathway_tpu/internals/chaos.py``).

The same seeded plans and streams as the reference (``random.Random`` keyed
``seed:kind:...``), so every draw equals the reference's for the same seed
and plan. In one process the port calls the commit kill
(``GraphRunner.step``), the object-store wrapper (``PersistenceManager``)
and the tiered index's faults (``ops/knn_tiers.py``); the frame, rejoin,
checkpoint, scale and replica hooks wait for the port's cluster runtime.

The reference's docstring follows. Failure paths are only trustworthy if
they are exercised the same way every time. This module injects faults from
a SEEDED plan so a failure schedule replays exactly:

- worker kills at chosen commit ids (``GraphRunner.step`` calls
  :meth:`Chaos.maybe_kill` at every commit boundary);
- dropped / delayed / truncated exchange frames (``ClusterExchange._send``
  consults :meth:`Chaos.frame_action` for every DATA frame — heartbeats are
  exempt so the injection counter stream stays deterministic per peer pair);
- transient object-store write errors (:meth:`Chaos.wrap_object_store` wraps
  the persistence backend; the engine's retry layer must absorb them);
- coordinated-checkpoint-phase faults (``checkpoint`` plan entries, keyed on
  the per-process checkpoint ATTEMPT counter ``at``): ``pre_snapshot_kill``
  SIGKILLs a rank at the START of attempt N (so exactly N checkpoints have
  completed — the attempt counter ticks with the wall-clock cadence, which
  keeps the schedule deterministic on loaded hosts where commit-id gating
  races convergence), ``post_snapshot_kill``
  SIGKILLs a rank between its snapshot write and the manifest commit,
  ``torn_manifest`` tears the manifest bytes mid-write (a non-atomic store),
  ``snapshot_error`` fails the snapshot write transiently — every one must
  leave the PREVIOUS checkpoint recoverable bit-identically.

Environment contract::

    PATHWAY_CHAOS_SEED   integer seed (default 0)
    PATHWAY_CHAOS_PLAN   JSON plan, e.g.
        {"kill":   [{"rank": 0, "commit": 3, "run": 0}],
         "frames": {"drop_prob": 0.0, "delay_prob": 0.0, "delay_ms": 10,
                    "truncate_prob": 0.0},
         "rejoin": [{"rank": 0, "run": 1}],
         "backend": {"put_error_prob": 0.5, "max_errors": 4},
         "checkpoint": [{"op": "post_snapshot_kill", "rank": 0, "run": 0, "at": 1}],
         "scale": [{"op": "scale_join_kill", "rank": 2, "run": 0, "at": 0}],
         "replica": [{"op": "replica_kill", "replica": 1, "commit": 5}],
         "load": {"op": "oscillating_load", "period_s": 4.0,
                  "low": 50, "high": 400},
         "sched": {"seed": 7}}

``load`` shapes a DETERMINISTIC synthetic offered-load profile for the
autoscaler/backpressure tests and the ``bench.py autoscale`` section — load
generators consult :meth:`Chaos.load_rate` the way the engine consults kill
schedules, so an overload scenario replays exactly. Ops: ``load_spike``
(``low`` rows/s, stepping to ``high`` at ``at_s`` for ``duration_s``),
``oscillating_load`` (square wave between ``low``/``high`` every
``period_s`` — the flap-lock scenario), and ``noisy_neighbor`` (flood
parameters one REST client applies while the others stay polite:
``client``/``rps``/``rows``; read via :meth:`Chaos.noisy_neighbor`).

``sched`` pins the deterministic model-check scheduler's seed
(``internals/sched.py`` — :meth:`Chaos.sched_seed`): a chaos plan can name the
exact protocol interleaving a model-check suite replays, the same way it names
kill commits. ``PATHWAY_SCHED_SEED`` overrides it.

``run`` in a kill entry matches ``PATHWAY_RESTART_COUNT`` (set by the
supervisor, 0 for a first launch), so a kill fires once and the restarted
cluster survives the replayed schedule; an optional ``epoch`` field further
gates the kill on the live cluster epoch (surgical-restart protocol testing:
kill-one-rank-at-commit-N-in-epoch-E). ``rejoin`` entries drop a relaunched
rank's rejoin handshake (``ClusterExchange._connect_rejoin`` consults
:meth:`Chaos.drop_rejoin`), deterministically forcing the surgical →
restart-all escalation; ``run`` there matches the REPLACEMENT's restart count
when present (omitted = every surgical attempt for that rank is dropped —
each attempt is a fresh process, so ``run`` is the only cross-attempt key).
Determinism comes from per-stream ``random.Random``
instances keyed ``seed:kind:rank:peer`` — the Nth draw on a stream is a pure
function of the seed and N, never of wall clock or other streams.

With ``PATHWAY_CHAOS_PLAN`` unset (whatever the seed), :func:`get_chaos`
returns ``None`` and every hook is a no-op attribute check on the caller's
side — zero overhead in production.
"""

from __future__ import annotations

import json
import os
import random
import signal
from typing import Any, Dict, List, Optional


class ChaosBackendError(ConnectionError):
    """Injected transient object-store failure (retryable by design)."""


#: every NAMED plan op per plan key — one registry, greppable, and the
#: source of truth the CHAOS.md drift audit checks BOTH ways (every op here
#: has a documented row; every documented op exists here). Plan keys whose
#: entries carry no ``op`` field (kill/frames/rejoin/backend/sched) gate on
#: their own fields and are documented as whole sections instead.
PLAN_OPS: Dict[str, tuple] = {
    "checkpoint": (
        "pre_snapshot_kill",
        "post_snapshot_kill",
        "torn_manifest",
        "snapshot_error",
    ),
    "scale": (
        "scale_join_kill",
        "scale_drain_kill",
        "handoff_torn",
        "join_handoff_torn",
        "dedup_install_kill",
        "chunk_stream_kill",
        "dropped_scale_handshake",
        "scale_refused",
    ),
    "index": (
        "rebuild_kill",
        "tier_swap_torn",
        "quant",
    ),
    "replica": (
        "replica_kill",
        "replica_lag",
        "replica_torn_bootstrap",
    ),
    "load": (
        "load_spike",
        "oscillating_load",
        "noisy_neighbor",
    ),
}


class _FrameAction:
    """One injection decision for an outgoing exchange frame."""

    __slots__ = ("kind", "delay_s")

    def __init__(self, kind: str, delay_s: float = 0.0):
        self.kind = kind  # "pass" | "drop" | "delay" | "truncate"
        self.delay_s = delay_s

    def __repr__(self) -> str:  # test/debug readability
        return f"_FrameAction({self.kind!r}, {self.delay_s})"


_PASS = _FrameAction("pass")


class Chaos:
    """Seeded injection schedule, one instance per process."""

    def __init__(self, seed: int, plan: Dict[str, Any]):
        self.seed = seed
        self.plan = plan
        self.run_count = int(os.environ.get("PATHWAY_RESTART_COUNT", "0") or 0)
        self._kills: List[Dict[str, Any]] = list(plan.get("kill") or [])
        self._frames: Dict[str, Any] = dict(plan.get("frames") or {})
        self._rejoins: List[Dict[str, Any]] = [
            dict(e) for e in (plan.get("rejoin") or [])
        ]
        self._backend: Dict[str, Any] = dict(plan.get("backend") or {})
        self._checkpoint: List[Dict[str, Any]] = [
            dict(e) for e in (plan.get("checkpoint") or [])
        ]
        self._scale: List[Dict[str, Any]] = [
            dict(e) for e in (plan.get("scale") or [])
        ]
        self._index: List[Dict[str, Any]] = [
            dict(e) for e in (plan.get("index") or [])
        ]
        self._replica: List[Dict[str, Any]] = [
            dict(e) for e in (plan.get("replica") or [])
        ]
        self._load: Dict[str, Any] = dict(plan.get("load") or {})
        self._streams: Dict[str, random.Random] = {}
        self._backend_errors_left = int(self._backend.get("max_errors", 3))
        # coordinated-checkpoint attempt counter: bumped by the runner at the
        # START of every attempt, so `at` in a checkpoint entry deterministically
        # names the Nth attempt of this process incarnation (0-based)
        self.checkpoint_attempt = -1
        # elastic-membership attempt counter, same discipline: `at` in a
        # scale entry names the Nth transition attempt of this incarnation
        self.scale_attempt = -1
        # tiered-index background-rebuild attempt counter: `at` in an index
        # entry names the Nth rebuild scheduled by this incarnation
        self.rebuild_attempt = -1
        # observability for tests: what actually fired
        self.stats: Dict[str, int] = {
            "kills": 0,
            "frames_dropped": 0,
            "frames_delayed": 0,
            "frames_truncated": 0,
            "rejoins_dropped": 0,
            "backend_errors": 0,
            "checkpoint_faults": 0,
            "scale_faults": 0,
            "index_faults": 0,
            "replica_faults": 0,
        }

    # -- streams -------------------------------------------------------------

    def _stream(self, kind: str, *key: Any) -> random.Random:
        name = ":".join([str(self.seed), kind, *map(str, key)])
        rng = self._streams.get(name)
        if rng is None:
            rng = random.Random(name)
            self._streams[name] = rng
        return rng

    # -- worker kills ---------------------------------------------------------

    def maybe_kill(self, rank: int, commit_id: int, epoch: int = 0) -> None:
        """SIGKILL this process if the plan schedules a kill at (rank, commit)
        for the current run (restart) count — and, when the entry carries an
        ``epoch`` field, only in that cluster epoch (kill-one-rank-at-commit-N
        schedules that target a specific incarnation of the mesh). Called at
        every LIVE commit boundary; journal replay never re-fires a kill."""
        for entry in self._kills:
            want_epoch = entry.get("epoch")
            if (
                int(entry.get("rank", -1)) == rank
                and int(entry.get("commit", -1)) == commit_id
                and int(entry.get("run", 0)) == self.run_count
                and (want_epoch is None or int(want_epoch) == int(epoch))
            ):
                self.stats["kills"] += 1
                # SIGKILL is uncatchable, so the flight recorder dumps HERE —
                # the injected death is the one failure mode that can leave a
                # complete black box behind (deferred import: internals-layer
                # modules must stay light at module load)
                try:
                    from pathway_tpu_torch.engine.profile import get_flight_recorder

                    recorder = get_flight_recorder()
                    recorder.record_event(
                        "chaos_kill", rank=rank, commit=commit_id, epoch=epoch
                    )
                    recorder.dump("chaos_kill")
                except Exception:
                    pass  # the kill must fire regardless
                os.kill(os.getpid(), signal.SIGKILL)

    # -- coordinated-checkpoint faults ----------------------------------------

    def begin_checkpoint_attempt(self) -> int:
        """Called by the runner at the start of every coordinated checkpoint
        attempt; returns the 0-based attempt index the ``at`` field gates on."""
        self.checkpoint_attempt += 1
        return self.checkpoint_attempt

    def checkpoint_fault(self, op: str, rank: int) -> bool:
        """True when the plan schedules fault ``op`` for this rank at the
        CURRENT checkpoint attempt (and restart count). ``at`` defaults to
        every attempt; ``run`` defaults to every incarnation."""
        for entry in self._checkpoint:
            if entry.get("op") != op:
                continue
            if int(entry.get("rank", -1)) != rank:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            want_at = entry.get("at")
            if want_at is not None and int(want_at) != self.checkpoint_attempt:
                continue
            self.stats["checkpoint_faults"] += 1
            self._record_injection(
                f"chaos_checkpoint_{op}", rank=rank, attempt=self.checkpoint_attempt
            )
            return True
        return False

    def maybe_checkpoint_kill(
        self, rank: int, commit_id: int, epoch: int = 0,
        op: str = "post_snapshot_kill",
    ) -> None:
        """SIGKILL this rank when a checkpoint-phase kill entry matches.
        ``post_snapshot_kill`` fires between the snapshot write and the
        manifest commit — the mid-protocol crash the manifest barrier exists
        to survive; ``pre_snapshot_kill`` fires at the start of the attempt,
        i.e. a plain rank death scheduled AFTER ``at`` completed checkpoints."""
        if not self.checkpoint_fault(op, rank):
            return
        self.stats["kills"] += 1
        try:
            from pathway_tpu_torch.engine.profile import get_flight_recorder

            recorder = get_flight_recorder()
            recorder.record_event(
                "chaos_checkpoint_kill", rank=rank, commit=commit_id, epoch=epoch,
                attempt=self.checkpoint_attempt,
            )
            recorder.dump("chaos_checkpoint_kill")
        except Exception:
            pass  # the kill must fire regardless
        os.kill(os.getpid(), signal.SIGKILL)

    # -- elastic-membership faults ---------------------------------------------

    def begin_scale_attempt(self) -> int:
        """Called by the runner at the start of every membership-transition
        attempt; returns the 0-based attempt index ``at`` gates on."""
        self.scale_attempt += 1
        return self.scale_attempt

    def scale_fault(self, op: str, rank: int) -> bool:
        """True when the plan schedules membership fault ``op`` for this rank
        at the CURRENT scale attempt (and restart count). Ops:

        - ``scale_join_kill``   — SIGKILL a joiner before it installs;
        - ``scale_drain_kill``  — SIGKILL a donor/leaver mid-handoff (after
          the quiesce vote, before its fragments are acked durable);
        - ``handoff_torn``     — tear a handoff-fragment write (the read-back
          verification must fail the attempt's ack barrier, previous state
          stands, the transition retries);
        - ``join_handoff_torn`` — tear ONLY a handoff chunk carrying join
          arrangement state (chunked transport; read-back verification fails
          the ack barrier exactly like ``handoff_torn``);
        - ``dedup_install_kill`` — SIGKILL the importer right before it
          applies a chunk carrying dedup instance state (the install barrier
          fails, the previous topology's state stands, the ladder replays);
        - ``chunk_stream_kill`` — SIGKILL the donor after its FIRST chunk
          write: the stream has no chunk manifest yet, so the half-written
          stream reads as absent (complete-or-abort);
        - ``dropped_scale_handshake`` — drop a joiner's membership hello so
          its wiring fails typed and the supervisor escalates;
        - ``scale_refused``    — inject a preflight-vote refusal (the runner
          appends a synthetic refusal reason), exercising the autoscaler's
          typed refusal-backoff path without a non-reshardable graph.

        ``at`` defaults to every attempt; ``run`` defaults to every
        incarnation (joiner relaunches bump PATHWAY_RESTART_COUNT, the
        cross-attempt key — same contract as ``rejoin`` entries). Joiner-side
        ops fire in a fresh process where ``begin_scale_attempt`` never ran:
        that counts as attempt 0, so ``at: 0`` gates them too."""
        current_attempt = max(0, self.scale_attempt)
        for entry in self._scale:
            if entry.get("op") != op:
                continue
            if int(entry.get("rank", -1)) != rank:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            want_at = entry.get("at")
            if want_at is not None and int(want_at) != current_attempt:
                continue
            self.stats["scale_faults"] += 1
            self._record_injection(
                f"chaos_{op}", rank=rank, attempt=self.scale_attempt,
                run=self.run_count,
            )
            return True
        return False

    def maybe_scale_kill(self, rank: int, op: str, **details: Any) -> None:
        """SIGKILL this rank when a membership fault entry matches (the
        ``scale_join_kill`` / ``scale_drain_kill`` ops)."""
        if not self.scale_fault(op, rank):
            return
        self.stats["kills"] += 1
        try:
            from pathway_tpu_torch.engine.profile import get_flight_recorder

            recorder = get_flight_recorder()
            recorder.record_event(
                f"chaos_{op}_kill", rank=rank, attempt=self.scale_attempt,
                **details,
            )
            recorder.dump(f"chaos_{op}")
        except Exception:
            pass  # the kill must fire regardless
        os.kill(os.getpid(), signal.SIGKILL)

    # -- tiered-index rebuild/swap faults ---------------------------------------

    def begin_rebuild_attempt(self) -> int:
        """Called by the tiered IVF store when it schedules a background
        rebuild; returns the 0-based attempt index ``at`` gates on."""
        self.rebuild_attempt += 1
        return self.rebuild_attempt

    def index_fault(self, op: str, rank: int) -> bool:
        """True when the plan schedules tiered-index fault ``op`` for this
        rank at the CURRENT rebuild attempt (and restart count). Ops:

        - ``rebuild_kill``   — SIGKILL the rank while a background index
          rebuild is in flight (the new generation must be discarded on
          recovery; journal replay rebuilds the index bit-identically);
        - ``tier_swap_torn`` — abort the generation swap at the commit
          boundary (the pending generation is dropped, the OLD generation
          keeps serving, and the next maintenance pass retries);
        - ``quant``          — abort a quantization-scale recalibration
          before the sidecar install (the OLD per-page scales keep serving;
          fp32 rows are untouched, so the exact rescore epilogue is
          unaffected and the next maintenance pass recalibrates).

        ``at`` defaults to every attempt; ``run`` defaults to every
        incarnation (the cross-restart key, same contract as ``scale``
        entries)."""
        current_attempt = max(0, self.rebuild_attempt)
        for entry in self._index:
            if entry.get("op") != op:
                continue
            if int(entry.get("rank", -1)) != rank:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            want_at = entry.get("at")
            if want_at is not None and int(want_at) != current_attempt:
                continue
            self.stats["index_faults"] += 1
            self._record_injection(
                f"chaos_{op}", rank=rank, attempt=self.rebuild_attempt,
                run=self.run_count,
            )
            return True
        return False

    def maybe_rebuild_kill(self, rank: int, **details: Any) -> None:
        """SIGKILL this rank when a ``rebuild_kill`` index entry matches —
        the kill lands while the background rebuild thread is mid-build, so
        recovery must come up serving the OLD generation (or a journal-replay
        rebuild), never a torn new one."""
        if not self.index_fault("rebuild_kill", rank):
            return
        self.stats["kills"] += 1
        try:
            from pathway_tpu_torch.engine.profile import get_flight_recorder

            recorder = get_flight_recorder()
            recorder.record_event(
                "chaos_rebuild_kill", rank=rank, attempt=self.rebuild_attempt,
                **details,
            )
            recorder.dump("chaos_rebuild_kill")
        except Exception:
            pass  # the kill must fire regardless
        os.kill(os.getpid(), signal.SIGKILL)

    # -- read-replica faults -----------------------------------------------------

    def replica_fault(self, op: str, replica: int) -> bool:
        """True when the plan schedules replica fault ``op`` for this replica
        id (and restart count). Ops:

        - ``replica_torn_bootstrap`` — tear a bootstrap-fragment read so the
          checksum verification fails typed (the replica must refuse and stay
          OUT of rotation, never serve from a torn install);
        - ``replica_lag``  — matched via :meth:`replica_lag_s` (injected
          apply delay, the deterministic staleness-shed scenario);
        - ``replica_kill`` — matched via :meth:`maybe_replica_kill`.

        ``run`` defaults to every incarnation (replica relaunches bump
        PATHWAY_RESTART_COUNT — the cross-attempt key, same contract as
        ``rejoin`` entries)."""
        for entry in self._replica:
            if entry.get("op") != op:
                continue
            if int(entry.get("replica", -1)) != replica:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            self.stats["replica_faults"] += 1
            self._record_injection(
                f"chaos_{op}", replica=replica, run=self.run_count
            )
            return True
        return False

    def replica_lag_s(self, replica: int) -> float:
        """Injected per-frame apply delay (seconds) for this replica, or 0.0.
        A ``frames`` field bounds how many applies pay the delay (default:
        every apply while the entry matches) — the bounded form lets a test
        drive the replica stale past its bound and then watch it catch up."""
        for entry in self._replica:
            if entry.get("op") != "replica_lag":
                continue
            if int(entry.get("replica", -1)) != replica:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            frames_left = entry.get("frames")
            if frames_left is not None:
                if int(frames_left) <= 0:
                    continue
                entry["frames"] = int(frames_left) - 1
            self.stats["replica_faults"] += 1
            self._record_injection(
                "chaos_replica_lag", replica=replica, run=self.run_count
            )
            return float(entry.get("lag_s", 0.1))
        return 0.0

    def maybe_replica_kill(self, replica: int, commit_id: int) -> None:
        """SIGKILL this replica process when a ``replica_kill`` entry matches
        (``commit`` gates on the replica's APPLIED commit id — omitted fires
        at the first applied frame). The router must route around the corpse:
        no client-visible 5xx."""
        for entry in self._replica:
            if entry.get("op") != "replica_kill":
                continue
            if int(entry.get("replica", -1)) != replica:
                continue
            want_commit = entry.get("commit")
            if want_commit is not None and int(want_commit) != commit_id:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            self.stats["kills"] += 1
            self.stats["replica_faults"] += 1
            try:
                from pathway_tpu_torch.engine.profile import get_flight_recorder

                recorder = get_flight_recorder()
                recorder.record_event(
                    "chaos_replica_kill", replica=replica, commit=commit_id,
                    run=self.run_count,
                )
                recorder.dump("chaos_replica_kill")
            except Exception:
                pass  # the kill must fire regardless
            os.kill(os.getpid(), signal.SIGKILL)

    # -- synthetic load profiles -----------------------------------------------

    def load_rate(self, elapsed_s: float) -> "Optional[float]":
        """Offered rows/s at ``elapsed_s`` into the run per the plan's
        ``load`` op, or None when no load profile is configured. A pure
        function of the plan and elapsed time — the autoscaler acceptance
        scenarios (ramp, spike, oscillation) replay exactly.

        - ``load_spike``: ``low`` until ``at_s``, then ``high`` for
          ``duration_s``, then ``low`` again;
        - ``oscillating_load``: square wave — ``high`` for the first half of
          every ``period_s`` window, ``low`` for the second (the scenario the
          controller's flap lock must survive)."""
        op = self._load.get("op")
        if op not in ("load_spike", "oscillating_load"):
            return None
        low = float(self._load.get("low", 0.0))
        high = float(self._load.get("high", low))
        if op == "load_spike":
            at_s = float(self._load.get("at_s", 0.0))
            duration_s = float(self._load.get("duration_s", 1.0))
            return high if at_s <= elapsed_s < at_s + duration_s else low
        period_s = max(1e-6, float(self._load.get("period_s", 2.0)))
        return high if (elapsed_s % period_s) < period_s / 2.0 else low

    def noisy_neighbor(self) -> "Optional[Dict[str, Any]]":
        """Flood parameters for the noisy-neighbor REST scenario (one client
        hammers ``/v1/retrieve`` while the others stay polite), or None.
        Keys: ``client`` (the flooding client id, default "noisy"), ``rps``
        (its request rate), ``rows`` (texts per request)."""
        if self._load.get("op") != "noisy_neighbor":
            return None
        return {
            "client": str(self._load.get("client", "noisy")),
            "rps": float(self._load.get("rps", 100.0)),
            "rows": int(self._load.get("rows", 4)),
        }

    # -- deterministic schedule seeds ------------------------------------------

    def sched_seed(self) -> "Optional[int]":
        """The plan's pinned model-check scheduler seed, or None. Consumed by
        ``internals/sched.py`` when neither an explicit seed nor
        ``PATHWAY_SCHED_SEED`` is given — chaos plans name protocol
        interleavings exactly like they name kill commits."""
        entry = self.plan.get("sched") or {}
        seed = entry.get("seed")
        return int(seed) if seed is not None else None

    # -- rejoin handshakes -----------------------------------------------------

    def drop_rejoin(self, rank: int) -> bool:
        """True when the plan schedules this relaunched rank's rejoin handshake
        to be dropped (the replacement's hello never reaches the survivors, so
        its wiring fails typed and the supervisor degrades to restart-all).

        Every replacement is a FRESH process that rebuilds this harness from
        the env, so cross-attempt gating must key on ``run`` (the
        replacement's ``PATHWAY_RESTART_COUNT`` — each escalation attempt has
        a distinct one), not on in-process counters. An entry without ``run``
        drops EVERY surgical attempt for that rank; recovery still terminates
        because the restart-all fallback never consults this schedule."""
        for entry in self._rejoins:
            if int(entry.get("rank", -1)) != rank:
                continue
            want_run = entry.get("run")
            if want_run is not None and int(want_run) != self.run_count:
                continue
            self.stats["rejoins_dropped"] += 1
            self._record_injection("chaos_rejoin_drop", rank=rank, run=self.run_count)
            return True
        return False

    # -- exchange frames -------------------------------------------------------

    def frame_action(self, rank: int, peer: int) -> _FrameAction:
        """Decide the fate of the next data frame ``rank -> peer``. Draws come
        from the per-(rank, peer) stream, so the schedule is independent of
        timing and of traffic to other peers."""
        if not self._frames:
            return _PASS
        rng = self._stream("frames", rank, peer)
        roll = rng.random()
        drop = float(self._frames.get("drop_prob", 0.0))
        trunc = float(self._frames.get("truncate_prob", 0.0))
        delay = float(self._frames.get("delay_prob", 0.0))
        if roll < drop:
            self.stats["frames_dropped"] += 1
            self._record_injection("chaos_frame_drop", rank=rank, peer=peer)
            return _FrameAction("drop")
        if roll < drop + trunc:
            self.stats["frames_truncated"] += 1
            self._record_injection("chaos_frame_truncate", rank=rank, peer=peer)
            return _FrameAction("truncate")
        if roll < drop + trunc + delay:
            self.stats["frames_delayed"] += 1
            return _FrameAction("delay", float(self._frames.get("delay_ms", 10)) / 1000.0)
        return _PASS

    @staticmethod
    def _record_injection(kind: str, **details: Any) -> None:
        """Destructive injections land in the flight recorder's event ring so
        a dump distinguishes injected faults from organic ones."""
        try:
            from pathway_tpu_torch.engine.profile import get_flight_recorder

            get_flight_recorder().record_event(kind, **details)
        except Exception:
            pass

    # -- persistence backends --------------------------------------------------

    def wrap_object_store(self, store: Any) -> Any:
        """Wrap an ``ObjectStore`` so PUTs fail transiently per the plan (a
        bounded number of times — the retry layer above must converge)."""
        if not self._backend:
            return store
        return _ChaosObjectStore(store, self)

    def _put_should_fail(self, key: str) -> bool:
        if self._backend_errors_left <= 0:
            return False
        prob = float(self._backend.get("put_error_prob", 0.0))
        if prob <= 0.0:
            return False
        if self._stream("backend").random() < prob:
            self._backend_errors_left -= 1
            self.stats["backend_errors"] += 1
            return True
        return False


class _ChaosObjectStore:
    """Injects transient write errors in front of a real ``ObjectStore``.

    Deliberately duck-typed (not an ``ObjectStore`` subclass): internals-layer
    code must not import the persistence package at module load."""

    def __init__(self, inner: Any, chaos: Chaos):
        self._inner = inner
        self._chaos = chaos

    def put(self, key: str, data: bytes) -> None:
        if self._chaos._put_should_fail(key):
            raise ChaosBackendError(
                f"chaos: injected transient write error for {key!r} "
                f"(seed {self._chaos.seed})"
            )
        self._inner.put(key, data)

    def get(self, key: str) -> "bytes | None":
        return self._inner.get(key)

    def list(self, prefix: str) -> List[str]:
        return self._inner.list(prefix)

    def delete(self, key: str) -> None:
        self._inner.delete(key)


_chaos: Optional[Chaos] = None
_chaos_tried = False


def get_chaos() -> Optional[Chaos]:
    """The process-wide chaos harness, or None when no plan is configured.
    Built once from the env; :func:`reset_chaos` rebuilds (tests)."""
    global _chaos, _chaos_tried
    if _chaos_tried:
        return _chaos
    plan_env = os.environ.get("PATHWAY_CHAOS_PLAN")
    if plan_env:
        try:
            plan = json.loads(plan_env)
        except ValueError as exc:
            raise ValueError(
                f"PATHWAY_CHAOS_PLAN is not valid JSON: {exc}"
            ) from exc
        seed = int(os.environ.get("PATHWAY_CHAOS_SEED", "0") or 0)
        _chaos = Chaos(seed, plan)
    else:
        _chaos = None
    _chaos_tried = True
    return _chaos


def reset_chaos() -> None:
    """Drop the cached harness so the next :func:`get_chaos` re-reads the env."""
    global _chaos, _chaos_tried
    _chaos = None
    _chaos_tried = False
