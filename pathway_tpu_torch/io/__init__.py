"""I/O connectors (port of ``pathway_tpu/io``): the python connector, the
REST connector and ``subscribe``. Other connectors are not ported."""

from pathway_tpu_torch.io import http, python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["http", "python", "subscribe"]
