"""``pw.io.subscribe`` — change callbacks (port of ``pathway_tpu/io/_subscribe.py``).

Per-row ``on_change(key, row, time, is_addition)``, and/or the columnar
``on_batch(keys, diffs, columns, time)`` once per commit.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.parse_graph import G


def subscribe(
    table: Any,
    on_change: Callable[..., None] | None = None,
    on_end: Callable[[], None] | None = None,
    on_time_end: Callable[[int], None] | None = None,
    name: str | None = None,
    *,
    on_batch: Callable[..., None] | None = None,
) -> None:
    """Call ``on_change(key, row, time, is_addition)`` for every row update of
    ``table``, and/or ``on_batch(keys, diffs, columns, time)`` once per commit."""
    if on_change is None and on_batch is None:
        raise ValueError("subscribe needs on_change and/or on_batch")

    callback = None
    if on_change is not None:
        def callback(key: Any, row: dict, time: int, is_addition: bool) -> None:
            on_change(key=key, row=row, time=time, is_addition=is_addition)

    G.add_node(
        pg.OutputNode(
            inputs=[table],
            callback=callback,
            batch_callback=on_batch,
            on_end=on_end,
            on_time_end=on_time_end,
        )
    )
