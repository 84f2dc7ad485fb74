"""Per-operator commit profiles, log-bucketed histograms, and the flight recorder
(port of ``pathway_tpu/engine/profile.py``).

The metrics plane in three pieces, all stdlib-only and always importable:

- :class:`LogHistogram` — power-of-two log-bucketed latency histogram (p50/p95/
  p99 without numpy), shared by commit duration and REST/retrieve latency and
  rendered as valid OpenMetrics histogram families by ``ProberStats``;
- :class:`EngineProfiler` — process-wide per-operator totals (wall seconds,
  rows, retractions per node), fed one :class:`CommitProfile` per commit by
  ``GraphRunner._run_node`` timings;
- :class:`FlightRecorder` — a bounded ring of the last N commit profiles plus
  serving events (brownout rungs, index rebuilds and swaps, int8 scale swaps),
  dumped as JSON on crash or on request — the post-mortem answer to "what was
  the engine doing right before it died" without reproducing the failure.

Everything here is a leaf: no engine imports, one lock per structure, and every
dump path swallows OSError — observability must never kill the worker. The
trace hooks are function-valued globals with no tracer registered yet, and
``note_barrier`` has no caller in a single-process engine.

Env knobs: ``PATHWAY_PROFILE=0`` disables per-operator timing;
``PATHWAY_FLIGHT_RECORDER=0`` disables the recorder;
``PATHWAY_FLIGHT_RECORDER_DIR`` sets the dump directory;
``PATHWAY_FLIGHT_RECORDER_COMMITS`` sizes the profile ring (default 64).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

# -- log-bucketed histogram ---------------------------------------------------

# power-of-two bucket bounds spanning ~1 µs .. 64 s: latencies below/above
# land in the first/overflow bucket. 27 finite bounds keeps the OpenMetrics
# exposition small enough to scrape every second.
_MIN_EXP = -20  # 2**-20 s ≈ 0.95 µs
_MAX_EXP = 6  # 2**6 s = 64 s


class LogHistogram:
    """Fixed power-of-two log buckets; O(1) observe, no dependencies.

    Quantiles interpolate log-linearly inside the winning bucket — accurate to
    a factor of 2**(1/count-in-bucket), plenty for p50/p95/p99 dashboards."""

    bounds = tuple(2.0**e for e in range(_MIN_EXP, _MAX_EXP + 1))

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # one slot per finite bound + the +Inf overflow slot
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_of(self, value: float) -> int:
        if value <= self.bounds[0]:
            return 0
        if value > self.bounds[-1]:
            return len(self.bounds)
        # frexp: value = m * 2**e with m in [0.5, 1). A value in
        # (2**(k-1), 2**k] belongs to bound 2**k, so k = e unless the value is
        # exactly a power of two (m == 0.5, inclusive le bound): then k = e-1.
        m, e = math.frexp(value)
        k = e if m > 0.5 else e - 1
        return min(max(k - _MIN_EXP, 0), len(self.bounds) - 1)

    def observe(self, value: float) -> None:
        value = max(0.0, float(value))
        idx = self._bucket_of(value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 when empty."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = q * total
        seen = 0
        for idx, n in enumerate(counts):
            if n == 0:
                continue
            if seen + n >= target:
                hi = self.bounds[idx] if idx < len(self.bounds) else self.bounds[-1] * 2
                lo = self.bounds[idx - 1] if 0 < idx <= len(self.bounds) else hi / 2
                frac = (target - seen) / n
                return lo * (hi / lo) ** frac
            seen += n
        return self.bounds[-1] * 2

    def percentiles(self) -> Dict[str, float]:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def openmetrics_lines(self, name: str, help_text: str) -> List[str]:
        """Render as one OpenMetrics histogram family (cumulative buckets,
        ``+Inf`` == ``_count``, ``_sum``)."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
            value_sum = self.sum
        lines = [
            f"# HELP {name} {help_text}",
            f"# TYPE {name} histogram",
        ]
        cumulative = 0
        for bound, n in zip(self.bounds, counts):
            cumulative += n
            lines.append(f'{name}_bucket{{le="{bound!r}"}} {cumulative}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{name}_count {total}")
        lines.append(f"{name}_sum {value_sum!r}")
        return lines

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.sum = 0.0
            self.count = 0


_hist_lock = threading.Lock()
_histograms: Dict[str, LogHistogram] = {}


def histogram(name: str) -> LogHistogram:
    """Process-wide named histogram (created on first use). Names must be
    valid OpenMetrics metric names — they are exported verbatim."""
    with _hist_lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = LogHistogram()
        return h


def histograms() -> Dict[str, LogHistogram]:
    with _hist_lock:
        return dict(_histograms)


def autoscale_signals(input_rows: "int | None" = None) -> Dict[str, float]:
    """One worker's autoscale-signal sample for its supervisor status file
    (``parallel/autoscaler.py`` aggregates these across ranks and the
    controller diffs the cumulative counters between samples):

    - ``input_rows``   — cumulative source rows ingested (the rate signal;
      the runner passes its ProberStats total);
    - ``shed``         — cumulative shed requests (embed + REST admission);
    - ``barrier_wait_s`` — cumulative exchange barrier-wait seconds (the
      straggler/imbalance signal, attributed per peer on /metrics);
    - ``commit_p99_s`` — commit-duration p99 (0 while profiling is off);
    - ``brownout_level`` — the serving plane's engaged degradation rung.

    Cheap by construction: two dict snapshots and one histogram quantile —
    called at the status-file cadence (~4/s), never per row."""
    from pathway_tpu_torch.engine import telemetry

    stages = telemetry.stage_snapshot()
    commit_hist = histograms().get("pathway_commit_duration_seconds")
    try:
        from pathway_tpu_torch.engine.brownout import get_brownout

        brownout_level = get_brownout().level()
    except Exception:
        brownout_level = 0
    return {
        "input_rows": float(input_rows or 0),
        "shed": float(
            stages.get("embed.shed", 0.0) + stages.get("rest.shed", 0.0)
        ),
        "barrier_wait_s": float(stages.get("exchange.barrier_wait_s", 0.0)),
        "commit_p99_s": (
            float(commit_hist.quantile(0.99))
            if commit_hist is not None and commit_hist.count
            else 0.0
        ),
        "brownout_level": float(brownout_level),
    }


# -- per-commit profiles ------------------------------------------------------


class CommitProfile:
    """What one commit did: wall seconds overall and per evaluator.

    ``ops`` entries are ``(node_id, name, kind, seconds, rows, retractions,
    neu)`` tuples — one per operator turn in ``GraphRunner._substep`` (the
    neu forgetting phase contributes separate entries with ``neu=True``, and
    the commit's ``neu`` says whether it ran). The port has no fused chains,
    so every row is one operator's own wall time."""

    __slots__ = (
        "commit", "rank", "duration_s", "input_rows", "output_rows", "neu",
        "ts", "ts_mono", "ops",
    )

    def __init__(
        self,
        *,
        commit: int,
        rank: int,
        duration_s: float,
        input_rows: int,
        output_rows: int,
        neu: bool,
        ops: List[tuple],
    ):
        self.commit = commit
        self.rank = rank
        self.duration_s = duration_s
        self.input_rows = input_rows
        self.output_rows = output_rows
        self.neu = neu
        # dual stamp: wall for cross-rank merge, monotonic for ordering that
        # survives a wall-clock step mid-run (trace merger + post-mortems)
        self.ts = time.time()
        self.ts_mono = time.monotonic()
        self.ops = ops

    def slowest_op(self) -> Optional[tuple]:
        if not self.ops:
            return None
        return max(self.ops, key=lambda op: op[3])

    def as_dict(self) -> Dict[str, Any]:
        return {
            "commit": self.commit,
            "rank": self.rank,
            "duration_s": self.duration_s,
            "input_rows": self.input_rows,
            "output_rows": self.output_rows,
            "neu": self.neu,
            "ts": self.ts,
            "ts_mono": self.ts_mono,
            "ops": [
                {
                    "node": node_id,
                    "name": name,
                    "kind": kind,
                    "seconds": seconds,
                    "rows": rows,
                    "retractions": retractions,
                    "neu": neu,
                }
                for node_id, name, kind, seconds, rows, retractions, neu in self.ops
            ],
        }


class EngineProfiler:
    """Process-wide per-operator totals + the commit-duration histogram.

    One lock acquisition per COMMIT (``record_commit`` folds the whole
    profile), not per operator — the per-operator timing itself is lock-free
    in the commit loop."""

    #: fold cadence: the hot path only appends; every Nth commit (or any
    #: read) folds the pending profiles into the totals and the histogram
    _FOLD_EVERY = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (node_id, name, kind) -> {"seconds", "rows", "retractions", "calls"}.
        # Keyed by the full triple, not node id alone: node ids restart at 0
        # for every graph built in this process (back-to-back runs, background
        # serving runners), and an id-only key would fold one graph's groupby
        # into another graph's input under the first comer's label.
        self._ops: Dict[tuple, Dict[str, Any]] = {}
        self._pending: List[CommitProfile] = []
        self.commits = 0
        self.commit_hist = histogram("pathway_commit_duration_seconds")

    def record_commit(self, profile: CommitProfile) -> None:
        """Hot path: one lock, one append. The dict folds and histogram
        observations are amortized over ``_FOLD_EVERY`` commits (readers fold
        first, so exports never lag)."""
        with self._lock:
            self.commits += 1
            self._pending.append(profile)
            if len(self._pending) >= self._FOLD_EVERY:
                self._fold_locked()

    def _fold_locked(self) -> None:
        pending, self._pending = self._pending, []
        for profile in pending:
            self.commit_hist.observe(profile.duration_s)
            for node_id, name, kind, seconds, rows, retractions, _neu in profile.ops:
                key = (node_id, name, kind)
                entry = self._ops.get(key)
                if entry is None:
                    entry = self._ops[key] = {
                        "seconds": 0.0,
                        "rows": 0,
                        "retractions": 0,
                        "calls": 0,
                    }
                entry["seconds"] += seconds
                entry["rows"] += rows
                entry["retractions"] += retractions
                entry["calls"] += 1

    def flush(self) -> None:
        """Fold any pending profiles (every reader calls this first)."""
        with self._lock:
            self._fold_locked()

    def operator_totals(self) -> List[Dict[str, Any]]:
        """Per-operator cumulative rows/seconds, sorted by node id."""
        with self._lock:
            self._fold_locked()
            return [
                {"node": node_id, "name": name, "kind": kind, **entry}
                for (node_id, name, kind), entry in sorted(self._ops.items())
            ]

    def snapshot(self) -> Dict[str, Any]:
        """The /v1/statistics shape: commit latency percentiles + the top
        operators by cumulative wall time."""
        ops = sorted(
            self.operator_totals(),  # folds pending first
            key=lambda e: e["seconds"],
            reverse=True,
        )
        pct = self.commit_hist.percentiles()
        return {
            "commits": self.commits,
            "commit_duration_ms": {k: v * 1000.0 for k, v in pct.items()},
            "operators": ops[:20],
        }

    def reset(self) -> None:
        with self._lock:
            self._ops = {}
            self._pending = []
            self.commits = 0
        self.commit_hist.reset()


_profiler = EngineProfiler()


def get_profiler() -> EngineProfiler:
    return _profiler


def profiling_enabled() -> bool:
    """Per-operator timing gate (``PATHWAY_PROFILE=0`` turns it off)."""
    return os.environ.get("PATHWAY_PROFILE", "").lower() not in (
        "0", "false", "no", "off",
    )


# -- flight recorder ----------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent commit profiles + cluster events, dumped as JSON
    on the ways a worker dies (crash, fence, stall-kill, SIGTERM, chaos kill).

    The dump's ``summary`` is the one-line post-mortem the supervisor prints:
    last completed commit, the slowest operator of that commit, and the
    exchange barrier that was pending at death (if any)."""

    _EVENT_RING = 256

    def __init__(self) -> None:
        # RLock, not Lock: dump() runs from the SIGTERM signal handler on the
        # main thread, which may have been interrupted between the bytecodes
        # of a record_commit that holds this lock — a non-reentrant lock
        # would deadlock the handler and make the process ignore SIGTERM.
        # Handler-time state is bytecode-consistent (deque ops are single C
        # calls), so reentering for a read-only snapshot is safe.
        self._lock = threading.RLock()
        size = 64
        try:
            size = max(1, int(os.environ.get("PATHWAY_FLIGHT_RECORDER_COMMITS", "64")))
        except ValueError:
            pass
        self.enabled = os.environ.get("PATHWAY_FLIGHT_RECORDER", "").lower() not in (
            "0", "false", "no", "off",
        )
        self._profiles: "collections.deque[CommitProfile]" = collections.deque(
            maxlen=size
        )
        self._events: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=self._EVENT_RING
        )
        self.rank = 0
        self._default_dir: Optional[str] = None
        # exchange tags currently blocking in a barrier recv, PER THREAD
        # (PATHWAY_THREADS workers share this process-wide recorder and
        # barrier concurrently; one slot would cross-clobber). Plain dict
        # set/del keyed by thread id — GIL-atomic, no lock on the hot path.
        self._pending_barriers: Dict[int, str] = {}
        self.dumps = 0

    def configure(self, *, rank: int, default_dir: Optional[str]) -> None:
        self.rank = rank
        if default_dir is not None:
            self._default_dir = default_dir

    # -- hot-path hooks (cheap, lock only on ring append) ---------------------

    def record_commit(self, profile: CommitProfile) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._profiles.append(profile)

    def record_event(self, kind: str, **details: Any) -> None:
        if not self.enabled:
            return
        event = {"ts": time.time(), "ts_mono": time.monotonic(), "kind": kind}
        event.update(details)
        with self._lock:
            self._events.append(event)

    def note_barrier(self, tag: Optional[bytes]) -> None:
        """The exchange layer marks the tag this THREAD is about to block on
        (and clears it on success) so a dump can name the pending barrier(s)
        at death."""
        tid = threading.get_ident()
        if tag is None:
            self._pending_barriers.pop(tid, None)
        else:
            self._pending_barriers[tid] = tag.decode("utf-8", "replace")

    def _pending_barrier_summary(self) -> "Optional[str]":
        pending = sorted(set(dict(self._pending_barriers).values()))
        if not pending:
            return None
        return pending[0] if len(pending) == 1 else ", ".join(pending)

    # -- dumping --------------------------------------------------------------

    def _resolve_dir(self) -> Optional[str]:
        return os.environ.get("PATHWAY_FLIGHT_RECORDER_DIR") or self._default_dir

    def dump_path(self, directory: Optional[str] = None) -> Optional[str]:
        directory = directory or self._resolve_dir()
        if directory is None:
            return None
        return os.path.join(directory, f"flight-rank-{self.rank}.json")

    def payload(self, reason: str) -> Dict[str, Any]:
        with self._lock:
            profiles = [p.as_dict() for p in self._profiles]
            events = list(self._events)
        last = profiles[-1] if profiles else None
        slowest = None
        if last and last["ops"]:
            op = max(last["ops"], key=lambda o: o["seconds"])
            slowest = {
                "name": op["name"], "kind": op["kind"], "seconds": op["seconds"],
            }
        trace = None
        spans_fn = _trace_spans_fn
        if spans_fn is not None:
            try:
                trace = spans_fn()
            except Exception:
                trace = None  # observability must never kill the worker
        return {
            "reason": reason,
            "rank": self.rank,
            "pid": os.getpid(),
            "ts": time.time(),
            "ts_mono": time.monotonic(),
            "profiles": profiles,
            "events": events,
            "trace": trace,
            "summary": {
                "last_commit": last["commit"] if last else None,
                "slowest_operator": slowest,
                "pending_barrier": self._pending_barrier_summary(),
            },
        }

    def dump(self, reason: str, directory: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``flight-rank-N.json`` (atomic rename); returns
        the path, or None when disabled / no dump dir is known. Never raises —
        a failing dump must not mask the failure being recorded."""
        if not self.enabled:
            return None
        path = self.dump_path(directory)
        if path is None:
            return None
        try:
            blob = json.dumps(self.payload(reason))
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
            self.dumps += 1
        except (OSError, TypeError, ValueError):
            return None
        flush_fn = _trace_flush_fn
        if flush_fn is not None:
            try:
                # partial-trace guarantee: the jsonl flush rides every dump
                # path (crash, fence, SIGTERM, chaos kill) so a dead rank's
                # spans land next to its flight dump
                flush_fn(os.path.dirname(path), reason)
            except Exception:
                pass
        return path

    def reset(self) -> None:
        with self._lock:
            self._profiles.clear()
            self._events.clear()
        self._pending_barriers = {}
        self.dumps = 0


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()

# tracing-plane hooks (registered by engine/tracing.py at tracer creation;
# function-valued module globals keep this module a leaf — no engine imports):
# _trace_spans_fn() -> recent-span payload embedded in every flight dump;
# _trace_flush_fn(directory, reason) flushes trace-rank-N.jsonl beside it.
_trace_spans_fn: Optional[Any] = None
_trace_flush_fn: Optional[Any] = None


def register_trace_hooks(spans_fn: Any, flush_fn: Any) -> None:
    global _trace_spans_fn, _trace_flush_fn
    _trace_spans_fn = spans_fn
    _trace_flush_fn = flush_fn


def get_flight_recorder() -> FlightRecorder:
    """Process-wide recorder (lazily built from the env): the engine feeds it
    profiles, the cluster/chaos layers feed it events, and any of them may
    trigger a dump."""
    global _recorder
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            rec = _recorder
            if rec is None:
                rec = _recorder = FlightRecorder()
    return rec


def reset_profile() -> None:
    """Test hook: clear the profiler, registered histograms, and the
    flight recorder ring (the recorder keeps its env-derived config)."""
    _profiler.reset()
    for h in histograms().values():
        h.reset()
    rec = _recorder
    if rec is not None:
        rec.reset()


def flight_summary_line(payload: Dict[str, Any]) -> str:
    """One-line human summary of a dump payload (shared by the supervisor's
    post-mortem and tests so the format has a single home)."""
    summary = payload.get("summary") or {}
    parts = [f"last commit {summary.get('last_commit')}"]
    slowest = summary.get("slowest_operator")
    if slowest:
        parts.append(
            f"slowest operator {slowest['name']} ({slowest['seconds'] * 1000:.1f} ms)"
        )
    pending = summary.get("pending_barrier")
    if pending:
        parts.append(f"pending barrier {pending}")
    reason = payload.get("reason")
    if reason:
        parts.append(f"reason {reason}")
    return ", ".join(parts)
