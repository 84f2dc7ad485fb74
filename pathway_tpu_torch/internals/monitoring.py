"""Run-progress monitoring (port of ``pathway_tpu/internals/monitoring.py``).

A rich-powered live terminal dashboard (operator rows, row counters, operator
seconds) with ``MonitoringLevel`` controlling detail. Falls back to plain
stderr lines off-tty or without rich — the plain path runs whenever the rich
live display is unavailable (no tty, no rich, a broken console), so
redirected/CI runs still see throttled progress. ``rich`` is imported only
when a tty asks for the live display.

The dashboard reads the engine's per-operator profile totals
(``engine/profile.py``): each operator row shows cumulative wall seconds and
rows/s next to the row counters, so "which operator is slow" is answerable
from the live view, not only from ``/metrics``.
"""

from __future__ import annotations

import enum
import sys
import time
from typing import Any, Dict, List


class MonitoringLevel(enum.Enum):
    AUTO = "auto"
    AUTO_ALL = "auto_all"
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


class StatsMonitor:
    """Operator-counter monitor: rich live table on a tty, plain lines otherwise."""

    def __init__(self, nodes: List[Any], level: MonitoringLevel = MonitoringLevel.AUTO):
        self.nodes = nodes
        self.level = level
        self.counts: Dict[int, int] = {}
        self.latest_commit_rows: Dict[int, int] = {}
        self.start = time.monotonic()
        self._last_print = 0.0
        self._live: Any = None
        if sys.stderr.isatty():
            try:
                from rich.console import Console
                from rich.live import Live

                # stderr console: program stdout stays clean under redirection
                self._live = Live(
                    self._render(0),
                    refresh_per_second=2,
                    transient=True,
                    console=Console(stderr=True),
                )
                self._live.start()
            except Exception:
                self._live = None

    def _interesting_nodes(self) -> List[Any]:
        show_all = self.level in (MonitoringLevel.ALL, MonitoringLevel.AUTO_ALL)
        out = []
        for node in self.nodes:
            if node.kind in ("input", "output") or show_all:
                out.append(node)
        return out

    def _profile_totals(self) -> Dict[tuple, dict]:
        """Per-operator cumulative seconds from the engine profiler, keyed by
        the full (node_id, name, kind) triple — node ids restart at 0 for
        every graph in the process, so an id-only key would show another
        graph's operator seconds. Empty when profiling is off (the dashboard
        then shows zeros, not a crash)."""
        try:
            from pathway_tpu_torch.engine.profile import get_profiler

            return {
                (e["node"], e["name"], e["kind"]): e
                for e in get_profiler().operator_totals()
            }
        except Exception:
            return {}

    def _render(self, commit: int) -> Any:
        from rich.table import Table

        elapsed = max(time.monotonic() - self.start, 1e-9)
        totals = self._profile_totals()
        table = Table(title=f"pathway_tpu_torch run — commit {commit}")
        table.add_column("operator")
        table.add_column("kind")
        table.add_column("rows in latest commit", justify="right")
        table.add_column("rows total", justify="right")
        table.add_column("time (s)", justify="right")
        table.add_column("rows/s", justify="right")
        for node in self._interesting_nodes():
            rows_total = self.counts.get(node.id, 0)
            seconds = totals.get(
                (node.id, node.name, node.kind), {}
            ).get("seconds", 0.0)
            table.add_row(
                node.name,
                node.kind,
                str(self.latest_commit_rows.get(node.id, 0)),
                str(rows_total),
                f"{seconds:.3f}",
                f"{rows_total / elapsed:.1f}",
            )
        table.caption = f"elapsed {elapsed:.1f}s"
        return table

    def update(
        self,
        commit: int,
        row_counts: Dict[int, int],
        states: Dict[int, Any] | None = None,
    ) -> None:
        self.latest_commit_rows = dict(row_counts)
        for node_id, n in row_counts.items():
            self.counts[node_id] = self.counts.get(node_id, 0) + n
        now = time.monotonic()
        if self._live is not None:
            if now - self._last_print > 0.4:
                self._last_print = now
                try:
                    self._live.update(self._render(commit))
                except Exception:
                    pass
        elif now - self._last_print > 1.0:
            # plain-line fallback whenever the rich live display is not
            # running — including redirected/non-tty stderr (CI logs), which
            # previously got NOTHING despite the module contract
            self._last_print = now
            total = sum(self.counts.values())
            elapsed = max(now - self.start, 1e-9)
            slowest = ""
            totals = self._profile_totals()
            if totals:
                worst = max(totals.values(), key=lambda e: e["seconds"])
                if worst["seconds"] > 0:
                    slowest = (
                        f" slowest={worst['name']}:{worst['seconds']:.2f}s"
                    )
            print(
                f"[pathway-tpu-torch] commit={commit} rows_processed={total} "
                f"rows_per_s={total / elapsed:.1f} "
                f"elapsed={elapsed:.1f}s{slowest}",
                file=sys.stderr,
            )

    def close(self) -> None:
        if self._live is not None:
            try:
                self._live.stop()
            except Exception:
                pass
            self._live = None
