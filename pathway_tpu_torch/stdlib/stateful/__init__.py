"""Stateful operators (port of ``pathway_tpu/stdlib/stateful``): ``deduplicate``."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table


def deduplicate(
    table: Table,
    *,
    value: Any,
    instance: Any = None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
) -> Table:
    return table.deduplicate(
        value=value, instance=instance, acceptor=acceptor, persistent_id=persistent_id
    )
