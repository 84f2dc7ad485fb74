"""Process-wide stage counters (port of the counters of ``pathway_tpu/engine/telemetry.py``).

Cumulative float counters keyed by name, under one lock: the serving path
counts into them under the reference's names (``embed.shed``,
``embed.svc.ticks``, ``embed.cache_hits``, ``brownout.engage``,
``rest.quiesce_shed``, ...). Spans, the metrics recorder, histograms and
``/metrics`` are not ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

_stage_lock = threading.Lock()
_stage_counters: Dict[str, float] = {}


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
