"""Retriever factory protocol (port of ``pathway_tpu/stdlib/indexing/retrievers.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class AbstractRetrieverFactory(ABC):
    """Builds a DataIndex over a data table + column (used by DocumentStore)."""

    @abstractmethod
    def build_index(self, data_column: Any, data_table: Any, **kwargs: Any) -> Any:
        ...
