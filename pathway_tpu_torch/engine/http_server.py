"""Per-process monitoring HTTP endpoint (port of ``pathway_tpu/engine/http_server.py``).

An OpenMetrics ``/status`` and ``/metrics`` endpoint on
``PATHWAY_MONITORING_HTTP_PORT`` (default 20000) + ``process_id``, exposing
the run's input/output latencies and row counters, every stage counter, the
per-operator profile totals and every registered log-bucketed histogram; and
``/healthz``, a JSON liveness probe.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

DEFAULT_MONITORING_HTTP_PORT = 20000


def _escape_label(value: str) -> str:
    """OpenMetrics label-value escaping (backslash, quote, newline)."""
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _format_value(value: float) -> str:
    """Ints render bare; floats keep full precision via repr."""
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def metrics_plane_lines() -> "list[str]":
    """The process-wide half of the /metrics exposition: every stage counter
    as a ``stage``-labeled counter family, per-operator totals, and every
    registered log-bucketed histogram. Shared by the worker's
    :meth:`ProberStats.to_openmetrics` and any later serving endpoint, so
    every surface passes the same strict-grammar tests — the renderer has
    ONE home. Returns lines WITHOUT the ``# EOF``
    terminator (callers append their own run-level families first)."""
    from pathway_tpu_torch.engine import profile as _profile
    from pathway_tpu_torch.engine import telemetry as _telemetry

    lines: "list[str]" = []
    stages = _telemetry.stage_snapshot()
    if stages:
        lines.append(
            "# HELP pathway_stage Cumulative in-process stage counters "
            "(keys ending _s are seconds)"
        )
        lines.append("# TYPE pathway_stage counter")
        for name in sorted(stages):
            lines.append(
                f'pathway_stage_total{{stage="{_escape_label(name)}"}} '
                f"{_format_value(stages[name])}"
            )
    totals = _profile.get_profiler().operator_totals()
    if totals:
        for family, key, help_text in (
            ("pathway_operator_seconds", "seconds", "Wall seconds per operator"),
            ("pathway_operator_rows", "rows", "Delta rows emitted per operator"),
            (
                "pathway_operator_retractions",
                "retractions",
                "Retraction rows emitted per operator",
            ),
        ):
            lines.append(f"# HELP {family} {help_text}")
            lines.append(f"# TYPE {family} counter")
            for entry in totals:
                lines.append(
                    f'{family}_total{{operator="{_escape_label(entry["name"])}"'
                    f',kind="{_escape_label(entry["kind"])}"'
                    f',node="{entry["node"]}"}} '
                    f"{_format_value(entry[key])}"
                )
    hists = _profile.histograms()
    for hist_name in sorted(hists):
        hist = hists[hist_name]
        if hist.count == 0:
            continue
        lines.extend(
            hist.openmetrics_lines(hist_name, f"Log-bucketed {hist_name}")
        )
    return lines


class ProberStats:
    """Shared run statistics, updated by the commit loop."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.started = time.time()
        self.last_input_time: Optional[float] = None
        self.last_output_time: Optional[float] = None
        self.input_finished = False
        self.rows_by_node: Dict[int, int] = {}
        self.input_rows = 0
        self.output_rows = 0
        self.commits = 0

    def record_commit(
        self, input_rows: int, output_rows: int, row_counts: Dict[int, int], finished: bool
    ) -> None:
        now = time.time()
        with self.lock:
            self.commits += 1
            if input_rows:
                self.last_input_time = now
                self.input_rows += input_rows
            if output_rows:
                self.last_output_time = now
                self.output_rows += output_rows
            for nid, n in row_counts.items():
                self.rows_by_node[nid] = self.rows_by_node.get(nid, 0) + n
            self.input_finished = finished

    def _latencies_locked(self, now: float) -> tuple:
        """(input_latency_ms, output_latency_ms); -1 when input is finished.
        Caller holds ``self.lock`` — the single home of the -1/started-fallback
        convention shared by the /status endpoint and the OTel gauges."""
        if self.input_finished:
            return (-1, -1)
        base_in = self.last_input_time if self.last_input_time is not None else self.started
        base_out = self.last_output_time if self.last_output_time is not None else self.started
        return (int((now - base_in) * 1000), int((now - base_out) * 1000))

    def latencies_ms(self) -> tuple:
        now = time.time()
        with self.lock:
            return self._latencies_locked(now)

    def to_openmetrics(self) -> str:
        """Full metrics plane as one OpenMetrics exposition: the run-level
        gauges/counters, every stage counter (exchange bytes/frames, barrier
        waits, embed pipeline, …) as a ``stage``-labeled counter family,
        per-operator wall-time/row/retraction totals labeled by operator
        name/kind, and every registered log-bucketed histogram (commit
        duration, REST latency) as a real histogram family."""
        now = time.time()
        with self.lock:
            input_latency, output_latency = self._latencies_locked(now)
            lines = [
                "# HELP input_latency_ms A latency of input in milliseconds (-1 when finished)",
                "# TYPE input_latency_ms gauge",
                f"input_latency_ms {input_latency}",
                "# HELP output_latency_ms A latency of output in milliseconds (-1 when finished)",
                "# TYPE output_latency_ms gauge",
                f"output_latency_ms {output_latency}",
                "# HELP input_rows A counter of rows ingested by input connectors",
                "# TYPE input_rows counter",
                f"input_rows_total {self.input_rows}",
                "# HELP output_rows A counter of rows delivered to sinks",
                "# TYPE output_rows counter",
                f"output_rows_total {self.output_rows}",
                "# HELP commits A counter of engine commits executed",
                "# TYPE commits counter",
                f"commits_total {self.commits}",
            ]
        lines.extend(metrics_plane_lines())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


class MonitoringServer:
    """Serves ``/status``+``/metrics`` (OpenMetrics) and ``/healthz`` (JSON
    liveness: per-peer heartbeat age, commit progress — the same payload the
    commit loop publishes to the supervisor's status file, so the supervisor
    and external probes share one signal)."""

    def __init__(self, stats: ProberStats, port: int):
        self.stats = stats
        # callable returning the liveness dict (None -> minimal alive
        # response)
        self.health_source: Optional[Any] = None
        stats_ref = stats
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path == "/healthz":
                    import json as _json

                    source = server_ref.health_source
                    try:
                        payload = source() if source is not None else {}
                    except Exception as exc:  # a probe must never 500 a worker
                        # ...but a failing probe callback is NOT healthy
                        # either: keep HTTP 200 + alive (the process serves)
                        # and surface the degradation instead of masking it
                        # behind a synthetic "running". The port runs one
                        # process, so no peer error can mean "fencing"
                        payload = {"error": str(exc), "state": "degraded"}
                    payload.setdefault("alive", True)
                    # a probe with nothing to report reads as a running worker
                    payload.setdefault("state", "running")
                    body = _json.dumps(payload, sort_keys=True).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path not in ("/status", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = stats_ref.to_openmetrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/openmetrics-text")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="pathway:monitoring-http"
        )
        self.thread.start()

    def close(self) -> None:
        """Idempotent: stop serving AND close the listener socket — a leaked
        listener holds the port across back-to-back runs in one process."""
        httpd, self.httpd = self.httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()


def maybe_start_http_server(stats: ProberStats, enabled: bool) -> Optional[MonitoringServer]:
    if not enabled:
        return None
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    base = cfg.monitoring_http_port or DEFAULT_MONITORING_HTTP_PORT
    port = base + cfg.process_id
    try:
        return MonitoringServer(stats, port)
    except OSError as exc:
        import logging

        logging.getLogger("pathway_tpu_torch").warning(
            "monitoring HTTP endpoint requested but port %d is unavailable: %s", port, exc
        )
        return None
