"""I/O connectors (port of ``pathway_tpu/io``): the python, REST, filesystem
(``fs``, ``csv``, ``jsonlines``, ``plaintext``) and null connectors, and
``subscribe``. Connectors whose client package the GPU machine lacks are not
ported."""

from pathway_tpu_torch.io import csv, fs, http, jsonlines, null, plaintext, python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["csv", "fs", "http", "jsonlines", "null", "plaintext", "python", "subscribe"]
