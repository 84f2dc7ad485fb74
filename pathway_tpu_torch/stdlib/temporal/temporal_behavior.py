"""Window behaviors (port of ``pathway_tpu/stdlib/temporal/temporal_behavior.py``).

``common_behavior(delay, cutoff, keep_results)`` controls when window results are emitted
(delay = buffer until time advances past start+delay), when late rows are ignored (cutoff),
and whether closed windows keep or forget their results. ``exactly_once_behavior`` is the
delay=cutoff special case. The engine's buffer / freeze / forget operators carry them out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


class Behavior:
    pass


@dataclass
class CommonBehavior(Behavior):
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any = None


def common_behavior(delay: Any = None, cutoff: Any = None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


def exactly_once_behavior(shift: Any = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)


def apply_temporal_behavior(
    table: Any, behavior: Optional[CommonBehavior], time_column: str = "_pw_time"
) -> Any:
    """Apply a behavior to a table carrying a time column: delay buffers rows, cutoff freezes late rows and
    forgets old ones."""
    if behavior is None:
        return table
    t = table[time_column]
    if behavior.delay is not None:
        table = table._buffer(t + behavior.delay, t)
        t = table[time_column]
    if behavior.cutoff is not None:
        table = table._freeze(t + behavior.cutoff, t)
        t = table[time_column]
        table = table._forget(t + behavior.cutoff, t, behavior.keep_results)
    return table
