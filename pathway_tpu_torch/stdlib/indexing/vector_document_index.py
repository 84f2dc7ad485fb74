"""Vector document index preset (port of
``pathway_tpu/stdlib/indexing/vector_document_index.py``): exact cosine
search over the dense store."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnMetricKind,
    _probe_embedder_dims,
)


def default_vector_document_index(
    data_column: expr.ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int | None = None,
    metadata_column: expr.ColumnReference | None = None,
    device: Any = None,
) -> DataIndex:
    if dimensions is None:
        dimensions = _probe_embedder_dims(embedder)
    return DataIndex(
        data_table,
        BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=dimensions,
            metric=BruteForceKnnMetricKind.COS,
            embedder=embedder,
            device=device,
        ),
    )
