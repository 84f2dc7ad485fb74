"""Time utilities (port of ``pathway_tpu/stdlib/temporal/time_utils.py``)."""

from __future__ import annotations

import datetime
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table


def utc_now(refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60)) -> Table:
    """A single-row table holding the current UTC timestamp, refreshed periodically."""
    import time

    from pathway_tpu_torch.io.python import ConnectorSubject, read
    from pathway_tpu_torch.internals.keys import pointer_from

    class _Clock(ConnectorSubject):
        def run(self) -> None:
            key_row = {"timestamp_utc": None}
            prev = None
            while True:
                now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
                if prev is not None:
                    self._emit({"timestamp_utc": prev}, diff=-1)
                self._emit({"timestamp_utc": now}, diff=1)
                prev = now
                time.sleep(refresh_rate.total_seconds())

    schema = sch.schema_from_types(timestamp_utc=datetime.datetime)
    return read(_Clock(), schema=schema)


def inactivity_detection(
    event_time_column: Any,
    allowed_inactivity_period: datetime.timedelta,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance: Any = None,
    *,
    now_table: Table | None = None,
) -> tuple:
    """Detect periods of inactivity and activity resumption in an event stream.

    Returns ``(inactivities, resumed_activities)``: tables with ``inactive_t`` (last
    event time before a detected gap) and ``resumed_t`` (first event after a gap).
    A wall-clock stream (:func:`utc_now`) is as-of-now joined against the latest
    event time per instance;
    gaps longer than ``allowed_inactivity_period`` raise an alert. ``now_table`` lets
    tests inject a deterministic clock stream instead of real wall-clock.
    """
    from pathway_tpu_torch.internals.reducers import reducers

    events_t = event_time_column.table.select(t=event_time_column, instance=instance)

    now_t = now_table if now_table is not None else utc_now(refresh_rate=refresh_rate)
    build_time = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    latest_t = events_t.groupby(events_t.instance).reduce(
        events_t.instance, latest_t=reducers.max(events_t.t)
    )
    if now_table is None:
        # avoid alerts while backfilling historical events
        latest_t = latest_t.filter(latest_t.latest_t > build_time)

    joined = now_t.asof_now_join(latest_t).select(
        timestamp_utc=now_t.timestamp_utc,
        instance=latest_t.instance,
        latest_t=latest_t.latest_t,
    )
    stale = joined.filter(
        joined.latest_t + allowed_inactivity_period < joined.timestamp_utc
    )
    inactivities = (
        stale.groupby(stale.latest_t, stale.instance)
        .reduce(stale.latest_t, stale.instance)
    )
    inactivities = inactivities.select(
        instance=inactivities.instance, inactive_t=inactivities.latest_t
    )

    latest_inactivity = inactivities.groupby(inactivities.instance).reduce(
        inactivities.instance, inactive_t=reducers.latest(inactivities.inactive_t)
    )
    ev_joined = events_t.asof_now_join(
        latest_inactivity, events_t.instance == latest_inactivity.instance
    ).select(
        t=events_t.t,
        instance=events_t.instance,
        inactive_t=latest_inactivity.inactive_t,
    )
    after_gap = ev_joined.filter(ev_joined.t > ev_joined.inactive_t)
    resumed_activities = (
        after_gap.groupby(after_gap.inactive_t, after_gap.instance)
        .reduce(after_gap.instance, resumed_t=reducers.min(after_gap.t))
    )
    if instance is None:
        inactivities = inactivities.without("instance")
        resumed_activities = resumed_activities.without("instance")
    return inactivities, resumed_activities
