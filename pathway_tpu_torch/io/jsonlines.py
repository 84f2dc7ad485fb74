"""JSON Lines connector (port of ``pathway_tpu/io/jsonlines.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

from pathway_tpu_torch.io import fs


def read(path: str | Path, *, schema: Any = None, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="jsonlines", schema=schema, mode=mode, **kwargs)


def write(table: Any, filename: str | Path, **kwargs: Any) -> None:
    fs.write(table, filename, format="json", **kwargs)
