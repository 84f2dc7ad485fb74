"""Sink helpers (port of ``pathway_tpu/io/_utils.py``)."""

from __future__ import annotations


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
