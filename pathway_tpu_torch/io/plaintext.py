"""Plaintext connector (port of ``pathway_tpu/io/plaintext.py``): one row per line."""

from __future__ import annotations

from pathlib import Path
from typing import Any

from pathway_tpu_torch.io import fs


def read(path: str | Path, *, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)
