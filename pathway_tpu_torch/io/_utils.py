"""Sink helpers (port of ``pathway_tpu/io/_utils.py``)."""

from __future__ import annotations


def plain_row(row: dict) -> dict:
    """Engine values → JSON-friendly plain Python values (one rule set for all sinks)."""
    from pathway_tpu_torch.internals.json import Json

    out = {}
    for k, v in row.items():
        if isinstance(v, Json):
            out[k] = v.value
        elif hasattr(v, "item"):
            out[k] = v.item()
        elif type(v).__name__ == "Pointer":
            out[k] = repr(v)
        else:
            out[k] = v
    return out


def columns_to_pylists(columns: dict, names: list) -> dict:
    """Columnar batch -> per-column Python lists for row-oriented sinks.

    ``tolist()`` on numeric columns yields native Python scalars (callbacks and
    JSON payloads must not see numpy scalars); datetime64 columns must NOT tolist
    (ns precision would degrade to raw int nanoseconds), and object columns pass
    through as-is.
    """
    return {
        c: (columns[c].tolist() if columns[c].dtype.kind in "ifb" else list(columns[c]))
        for c in names
    }


def add_batched_sink(
    table,
    write_rows,
    *,
    max_batch_size: int,
    client=None,
):
    """Shared OutputNode scaffolding for document sinks (mongodb/bigquery):
    rows carry ``time``/``diff``, batch up to ``max_batch_size``, flush at every
    commit boundary and at close; ``client.close()`` (when present) runs after
    the final flush."""
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.internals.parse_graph import G

    batch: list[dict] = []

    def flush() -> None:
        if batch:
            rows, batch[:] = list(batch), []
            write_rows(rows)

    def callback(key, row: dict, time: int, is_addition: bool) -> None:
        batch.append({**plain_row(row), "time": time, "diff": 1 if is_addition else -1})
        if len(batch) >= max_batch_size:
            flush()

    def close() -> None:
        flush()
        close_fn = getattr(client, "close", None)
        if close_fn is not None:
            close_fn()

    G.add_node(
        pg.OutputNode(
            inputs=[table],
            callback=callback,
            on_end=close,
            on_time_end=lambda _t: flush(),
        )
    )
