"""Full-text document index preset (port of
``pathway_tpu/stdlib/indexing/full_text_document_index.py``)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex


def default_full_text_document_index(
    data_column: expr.ColumnReference,
    data_table: Table,
    *,
    metadata_column: expr.ColumnReference | None = None,
) -> DataIndex:
    return DataIndex(data_table, TantivyBM25(data_column, metadata_column))
