"""Temporal stdlib: windows, interval joins, asof joins, behaviors (port of
``pathway_tpu/stdlib/temporal/``).

``windowby`` with session / sliding / tumbling / intervals-over windows,
``interval_join*``, ``asof_join*``, ``asof_now_join*``, ``window_join*`` and the
window behaviors, on the port's engine. Mechanism: windows desugar to flatten+groupby over computed
window keys (batch-incremental); interval joins use the two-bucket expansion trick so each
matching pair joins exactly once; asof joins aggregate the right side into per-key sorted
tuples and binary-search row-wise.
"""

from pathway_tpu_torch.stdlib.temporal._window import (
    Window,
    intervals_over,
    session,
    sliding,
    tumbling,
    windowby,
)
from pathway_tpu_torch.stdlib.temporal._interval_join import (
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
)
from pathway_tpu_torch.stdlib.temporal._asof_join import (
    AsofDirection,
    Direction,
    asof_join,
    asof_join_inner,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
)
from pathway_tpu_torch.stdlib.temporal._window_join import (
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    apply_temporal_behavior,
    common_behavior,
    exactly_once_behavior,
)
from pathway_tpu_torch.stdlib.temporal.time_utils import inactivity_detection, utc_now

__all__ = [
    "AsofDirection",
    "Direction",
    "Behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "Window",
    "asof_join",
    "asof_join_inner",
    "asof_join_left",
    "asof_join_outer",
    "asof_join_right",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
    "apply_temporal_behavior",
    "common_behavior",
    "exactly_once_behavior",
    "inactivity_detection",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_outer",
    "interval_join_right",
    "intervals_over",
    "session",
    "sliding",
    "tumbling",
    "utc_now",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_outer",
    "window_join_right",
    "windowby",
]
