"""Telemetry of the port (port of ``pathway_tpu/engine/telemetry.py``).

- **Stage counters**, always on: cumulative float counters keyed by name,
  under one lock. The serving path counts into them under the reference's
  names (``embed.shed``, ``embed.svc.ticks``, ``embed.cache_hits``,
  ``brownout.engage``, ``rest.quiesce_shed``, ``index.*``, ...).
- **The registries** ``STAGE_NAMESPACES``, ``FLIGHT_EVENT_KINDS`` and
  ``TRACE_SPAN_KINDS``: the names a counter, a flight event or a span may
  take.
- **OpenTelemetry spans and metrics**, deferred AND gated: importing
  ``opentelemetry.context`` scans every installed distribution's entry
  points, so the no-op default never pays it. Enable with
  ``PATHWAY_TELEMETRY=1`` (or by importing ``opentelemetry.sdk`` before
  ``pw.run``). Without ``opentelemetry`` or ``psutil`` installed, spans and
  :class:`MetricsRecorder` stay no-ops.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator


def _telemetry_requested(module: str) -> bool:
    """One home for the enablement rule shared by traces and metrics: the
    PATHWAY_TELEMETRY env gate, or the relevant OTel module already imported
    (an operator wiring an SDK provider implies intent)."""
    requested = os.environ.get("PATHWAY_TELEMETRY", "").lower() not in (
        "", "0", "false", "no", "off",
    )
    return requested or module in sys.modules


def _tracer() -> Any:
    try:
        if not _telemetry_requested("opentelemetry.trace"):
            return None  # no SDK configured and not requested: stay no-op, import-free
        from opentelemetry import trace

        return trace.get_tracer("pathway_tpu_torch")
    except Exception:
        return None


@contextlib.contextmanager
def span(name: str, **attributes: Any) -> Iterator[None]:
    tracer = _tracer()
    if tracer is None:
        yield
        return
    with tracer.start_as_current_span(name) as current:
        for key, value in attributes.items():
            try:
                current.set_attribute(key, value)
            except Exception:
                pass
        yield


_stage_lock = threading.Lock()
_stage_counters: Dict[str, float] = {}


#: THE registered stage-counter namespaces (the reference's, verbatim). Every
#: ``stage_add``/``stage_timer``/``stage_add_many`` literal must live under one
#: of these prefixes, so a typo'd or forked counter name cannot silently
#: diverge from the /metrics dashboards. Adding a new subsystem = adding its
#: prefix HERE (one home, greppable).
STAGE_NAMESPACES: "tuple[str, ...]" = (
    "autoscale.",   # closed-loop autoscaler decisions/flaps
    "brownout.",    # overload-degradation ladder rungs + quiesce
    "cluster.",     # mesh fences/rejoins/membership/reshard
    "embed.",       # embed pipeline, caches, encoder service (embed.svc.*)
    "eval.",        # batch-UDF evaluation
    "exchange.",    # per-peer traffic + barrier waits/stragglers
    "fuse.",        # whole-commit fusion planner/jit
    "index.",       # tiered IVF index: tier hits, prefetch, rebuild/swap
    "index.quant.", # int8 retrieval: rescore batches, recalibrations, audits
    "lint.",        # graph/runtime lint diagnostics
    "modelcheck.",  # deterministic schedule exploration
    "persist.",     # checkpoints, journal compaction
    "replica.",     # read-replica fleet: feed, follow, serve/shed, failover
    "rest.",        # REST admission/shed plane
    "trace.",       # distributed-tracing plane: spans, promotions, flushes
)

#: registered flight-recorder event kinds (``FlightRecorder.record_event``
#: literals) — same contract as STAGE_NAMESPACES, so post-mortem tooling
#: keyed on these names cannot silently miss an event.
FLIGHT_EVENT_KINDS: "frozenset[str]" = frozenset({
    "autoscale",
    "barrier_timeout",
    "brownout",
    "chaos_checkpoint_kill",
    "chaos_kill",
    "chaos_quant_kill",
    "chaos_rebuild_kill",
    "chaos_replica_kill",
    "chaos_replica_lag",
    "chaos_replica_torn_bootstrap",
    "checkpoint",
    "checkpoint_deferred",
    "drained",
    "fence",
    "fence_broadcast",
    "fence_received",
    "fusion",
    "index_rebuild",
    "index_swap",
    "lint",
    "membership",
    "membership_applied",
    "membership_left",
    "modelcheck",
    "peer_stale",
    "preflight_refuse",
    "quant_swap",
    "rejoin",
    "rejoin_installed",
    "replica_bootstrap",
    "replica_failover",
    "replica_refused",
    "trace_flush",
})

#: registered distributed-tracing span kinds (``tracing.trace_span`` /
#: ``start``/``record_span`` literal first args) — same contract as
#: STAGE_NAMESPACES/FLIGHT_EVENT_KINDS, so the merger and critical-path
#: tooling keyed on these kinds cannot silently miss a span.
TRACE_SPAN_KINDS: "frozenset[str]" = frozenset({
    "barrier",       # exchange barrier wait (carries straggler attribution)
    "checkpoint",    # coordinated checkpoint write inside a commit
    "coalesce",      # query-coalescer admission wait
    "commit",        # one engine commit (deterministic cross-rank trace id)
    "encode",        # encoder-service tick (links N parent query spans)
    "exchange",      # mesh delta receive (links the sender's commit span)
    "fused_region",  # one fused chain executed as a single program
    "operator",      # one evaluator run (synthesized from CommitProfile ops)
    "replica_apply", # replica applying a commit frame from the feed
    "replica_serve", # replica answering a read (links the commit it serves)
    "rest",          # one REST route invocation (X-Pathway-Trace in/out)
})


def stage_add(name: str, value: float = 1.0) -> None:
    """Add ``value`` to the cumulative counter ``name``."""
    with _stage_lock:
        _stage_counters[name] = _stage_counters.get(name, 0.0) + value


def stage_add_many(updates: Dict[str, float]) -> None:
    """Several increments under one lock acquisition."""
    with _stage_lock:
        for name, value in updates.items():
            _stage_counters[name] = _stage_counters.get(name, 0.0) + value


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    """Accumulate wall seconds under ``<name>_s`` and bump ``<name>_calls``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        with _stage_lock:
            _stage_counters[name + "_s"] = _stage_counters.get(name + "_s", 0.0) + elapsed
            _stage_counters[name + "_calls"] = _stage_counters.get(name + "_calls", 0.0) + 1


def stage_snapshot(prefix: str | None = None) -> Dict[str, float]:
    """Copy of the counters (optionally only those under ``prefix``)."""
    with _stage_lock:
        if prefix is None:
            return dict(_stage_counters)
        return {k: v for k, v in _stage_counters.items() if k.startswith(prefix)}


def stage_reset(prefix: str | None = None) -> None:
    with _stage_lock:
        if prefix is None:
            _stage_counters.clear()
        else:
            for k in [k for k in _stage_counters if k.startswith(prefix)]:
                del _stage_counters[k]


# -- metrics (OTLP process mem/cpu + latency) ---------------------------------


def _metrics_enabled() -> bool:
    return _telemetry_requested("opentelemetry.metrics")


class MetricsRecorder:
    """OpenTelemetry metric instruments around runs (reference
    ``telemetry.rs:37-45``: process memory/cpu observable gauges, input/output
    latency gauges, row counters @ the meter's export interval).

    Instruments go through the opentelemetry METRICS API: a no-op without a
    configured ``MeterProvider``; operators wire an OTLP (or any) exporter by
    setting the global provider before ``pw.run``. Process stats come from
    psutil, sampled by the SDK's observation callbacks — zero cost per commit.

    Process-wide SINGLETON (``MetricsRecorder.get``): instruments register on
    the global meter exactly once; repeated ``pw.run`` calls (notebooks, the
    export/import pattern) swap which run's ``ProberStats`` feeds the latency
    gauges instead of piling up duplicate instruments and leaked callbacks.
    """

    _instance: "MetricsRecorder | None" = None

    @classmethod
    def get(cls, prober_stats: Any = None) -> "MetricsRecorder":
        if cls._instance is None or (
            not cls._instance._enabled and _metrics_enabled()
        ):
            # telemetry may be switched on BETWEEN runs (notebooks): a disabled
            # cached instance rebuilds once enablement appears; an enabled one
            # is never rebuilt (instruments must register exactly once)
            cls._instance = cls()
        cls._instance._stats = prober_stats
        return cls._instance

    def __init__(self):
        self._enabled = False
        self._stats: Any = None  # the CURRENT run's ProberStats (gauges read it)
        self._commit_counter: Any = None
        self._input_counter: Any = None
        self._output_counter: Any = None
        self._latency_hist: Any = None
        if not _metrics_enabled():
            return
        try:
            from opentelemetry import metrics

            meter = metrics.get_meter("pathway_tpu_torch")
            import psutil

            process = psutil.Process()
            # prime the cpu clock: cpu_percent(interval=None) measures SINCE
            # the previous call, so an unprimed first sample reports 0.0 for
            # the whole first export interval
            process.cpu_percent(interval=None)

            def _mem_cb(_options: Any) -> list:
                from opentelemetry.metrics import Observation

                return [Observation(process.memory_info().rss)]

            def _cpu_cb(_options: Any) -> list:
                from opentelemetry.metrics import Observation

                return [Observation(process.cpu_percent(interval=None))]

            def _input_latency_cb(_options: Any) -> list:
                from opentelemetry.metrics import Observation

                stats = self._stats
                if stats is None:
                    return []
                ms = stats.latencies_ms()[0]
                return [Observation(ms)] if ms >= 0 else []

            def _output_latency_cb(_options: Any) -> list:
                from opentelemetry.metrics import Observation

                stats = self._stats
                if stats is None:
                    return []
                ms = stats.latencies_ms()[1]
                return [Observation(ms)] if ms >= 0 else []

            meter.create_observable_gauge(
                "process.memory.usage", callbacks=[_mem_cb], unit="By",
                description="resident set size",
            )
            meter.create_observable_gauge(
                "process.cpu.utilization", callbacks=[_cpu_cb], unit="%",
            )
            meter.create_observable_gauge(
                "pathway.input.latency", callbacks=[_input_latency_cb], unit="ms",
            )
            meter.create_observable_gauge(
                "pathway.output.latency", callbacks=[_output_latency_cb], unit="ms",
            )
            self._commit_counter = meter.create_counter(
                "pathway.commits", description="commits processed"
            )
            self._input_counter = meter.create_counter(
                "pathway.input.rows", description="source rows ingested"
            )
            self._output_counter = meter.create_counter(
                "pathway.output.rows", description="rows delivered to sinks"
            )
            self._latency_hist = meter.create_histogram(
                "pathway.commit.duration", unit="s",
            )
            self._enabled = True
        except Exception:
            self._enabled = False

    def record_commit(self, input_rows: int, output_rows: int, duration_s: float) -> None:
        if not self._enabled:
            return
        try:
            self._commit_counter.add(1)
            if input_rows:
                self._input_counter.add(input_rows)
            if output_rows:
                self._output_counter.add(output_rows)
            self._latency_hist.record(duration_s)
        except Exception:
            pass
