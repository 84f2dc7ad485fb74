"""Overload brownout ladder for the serving plane (port of ``pathway_tpu/engine/brownout.py``).

When the embed admission queue saturates, the serving plane degrades
gracefully: admission caps tighten and retrieval gets cheaper.

Rungs (driven by embed-queue occupancy, the fraction of
``max_queue_rows`` waiting or in flight):

====  ==================  =============================================
rung  engages at           degradation
====  ==================  =============================================
0     —                   none (normal serving)
1     occupancy >= 0.60   REST admission cap x0.5, coalesce window x0.5
2     occupancy >= 0.85   REST admission cap x0.25, coalesce window ->0,
                          IVF ``n_probe`` halved
====  ==================  =============================================

Rungs release with hysteresis: occupancy must stay below 70% of the engage
threshold for ``hold_s`` seconds before a rung disengages. Every engage /
release bumps the ``brownout.engage`` / ``brownout.release`` stage counters
and records a ``brownout`` flight-recorder event (action, from / to level,
occupancy).

The **quiesce window** rides the same registry: while the commit loop is
paused, the REST plane answers 429 with the expected remaining pause as
``Retry-After`` instead of letting clients hang (:meth:`enter_quiesce` /
:meth:`exit_quiesce`, consulted by ``rest_connector`` before admission).

``PATHWAY_BROWNOUT=off`` disables the ladder (level stays 0; the quiesce
window still sheds). Process-wide singleton via :func:`get_brownout`;
:func:`reset_brownout` rebuilds it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.profile import get_flight_recorder

# (engage_occupancy, admission_scale, coalesce_window_scale, nprobe_shift)
# per rung, rung 0 implicit
_RUNGS = (
    (0.60, 0.5, 0.5, 0),
    (0.85, 0.25, 0.0, 1),
)
# occupancy must stay below engage * _RELEASE_RATIO for hold_s to disengage
_RELEASE_RATIO = 0.7


def retry_after_int(seconds: float) -> str:
    """RFC 9110 ``Retry-After`` value: a non-negative integer of seconds,
    rounded up, at least 1 and at most 3600 (NaN and negatives give 1)."""
    try:
        value = float(seconds)
    except (TypeError, ValueError):
        value = 1.0
    if value != value or value < 0:
        value = 1.0
    value = min(value, 3600.0)
    return str(max(1, int(-(-value // 1))))


class BrownoutState:
    """Thread-safe overload-degradation ladder (see the module docstring)."""

    def __init__(self, *, enabled: "bool | None" = None, hold_s: float = 1.0):
        if enabled is None:
            enabled = os.environ.get("PATHWAY_BROWNOUT", "on").lower() not in (
                "off", "0", "false", "no",
            )
        self.enabled = bool(enabled)
        self.hold_s = float(hold_s)
        self._lock = threading.Lock()
        self._level = 0
        # per rung: the last time occupancy was above its release threshold
        self._last_above = [0.0] * len(_RUNGS)
        self._engages = 0
        self._releases = 0
        # (entered_monotonic, expected_duration_s) while quiesced
        self._quiesce: "Optional[tuple]" = None

    # -- ladder ----------------------------------------------------------------

    def observe_occupancy(self, frac: float, now: "float | None" = None) -> int:
        """Feed one embed-queue occupancy sample (0..1+); returns the level
        after the update."""
        if not self.enabled:
            return 0
        if now is None:
            now = time.monotonic()
        frac = max(0.0, float(frac))
        events = []
        with self._lock:
            old = self._level
            for i, (engage, _adm, _win, _np) in enumerate(_RUNGS):
                if frac >= engage * _RELEASE_RATIO:
                    self._last_above[i] = now
            # engage the deepest rung whose threshold the sample crosses
            level = self._level
            for i, (engage, _adm, _win, _np) in enumerate(_RUNGS):
                if frac >= engage:
                    level = max(level, i + 1)
            # release any rung that stayed quiet for hold_s
            while level > 0:
                i = level - 1
                if frac < _RUNGS[i][0] and now - self._last_above[i] >= self.hold_s:
                    level -= 1
                else:
                    break
            self._level = level
            if level > old:
                self._engages += level - old
                events.append(("engage", old, level, frac))
            elif level < old:
                self._releases += old - level
                events.append(("release", old, level, frac))
        for kind, frm, to, occ in events:
            self._emit(kind, frm, to, occ)
        return level

    def _emit(self, kind: str, from_level: int, to_level: int, occupancy: float) -> None:
        telemetry.stage_add(f"brownout.{kind}")
        try:
            get_flight_recorder().record_event(
                "brownout",
                action=kind,
                from_level=from_level,
                to_level=to_level,
                occupancy=round(float(occupancy), 3),
            )
        except Exception:
            pass  # observability must never fail the serving path

    def level(self) -> int:
        with self._lock:
            return self._level

    def _rung(self, field: int, default: float) -> Any:
        with self._lock:
            level = self._level
        return _RUNGS[level - 1][field] if level > 0 else default

    def admission_scale(self) -> float:
        """Multiplier on the REST ``max_pending`` cap (1.0 at rung 0)."""
        return self._rung(1, 1.0)

    def coalesce_window_scale(self) -> float:
        """Multiplier on the query coalescer's ``max_wait_ms`` window."""
        return self._rung(2, 1.0)

    def nprobe_shift(self) -> int:
        """Right shift applied to IVF ``n_probe`` at query time (rung 2:
        half the probes)."""
        return self._rung(3, 0)

    # -- quiesce window --------------------------------------------------------

    def enter_quiesce(self, expected_s: float = 1.0) -> None:
        """The commit loop is paused: shed REST requests (429 with the
        expected remaining pause) until :meth:`exit_quiesce`. Active whether
        or not the ladder is enabled."""
        with self._lock:
            self._quiesce = (time.monotonic(), max(0.1, float(expected_s)))
        telemetry.stage_add("brownout.quiesce_enter")

    def exit_quiesce(self) -> None:
        with self._lock:
            self._quiesce = None

    def quiesce_retry_after(self) -> "Optional[float]":
        """Remaining expected pause in seconds while quiesced, else None."""
        with self._lock:
            quiesce = self._quiesce
        if quiesce is None:
            return None
        entered, expected = quiesce
        return max(0.5, expected - (time.monotonic() - entered))

    # -- reporting -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "level": self._level,
                "engages": self._engages,
                "releases": self._releases,
                "quiesced": self._quiesce is not None,
                "enabled": self.enabled,
            }


_brownout: "Optional[BrownoutState]" = None
_brownout_lock = threading.Lock()


def get_brownout() -> BrownoutState:
    """The process-wide brownout ladder (built once from the env)."""
    global _brownout
    with _brownout_lock:
        if _brownout is None:
            _brownout = BrownoutState()
        return _brownout


def reset_brownout() -> None:
    """Drop the singleton so the next :func:`get_brownout` re-reads the env."""
    global _brownout
    with _brownout_lock:
        _brownout = None
