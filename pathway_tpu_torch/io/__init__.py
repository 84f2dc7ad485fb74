"""I/O connectors (port of ``pathway_tpu/io``): the python, REST, filesystem
(``fs``, ``csv``, ``jsonlines``, ``plaintext``), null, ``pyfilesystem`` (over
the caller's FS object) and ``sqlite`` connectors, ``subscribe``, and the
cross-graph handoff ``export_table`` / ``import_table`` / ``ExportedTable``.
Connectors whose client package the GPU machine lacks are not ported."""

from pathway_tpu_torch.io import (
    csv,
    fs,
    http,
    jsonlines,
    null,
    plaintext,
    pyfilesystem,
    python,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io.export_import import ExportedTable, export_table, import_table

__all__ = [
    "csv",
    "fs",
    "http",
    "jsonlines",
    "null",
    "plaintext",
    "pyfilesystem",
    "python",
    "sqlite",
    "subscribe",
    "ExportedTable",
    "export_table",
    "import_table",
]
