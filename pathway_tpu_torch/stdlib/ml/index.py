"""KNNIndex — the classic index API over a vector column (port of
``pathway_tpu/stdlib/ml/index.py``).

Exact brute force by default (the dense device store of ``ops/knn.py``),
``approximate="ivf"`` (the IVF store, whose page scorer is the CUDA kernel
``csrc/score_pages.cu``) or ``"lsh"`` with ``exact=False``. The index lives
on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnMetricKind,
    IvfKnn,
    LshKnn,
)


class KNNIndex:
    """K-nearest-neighbors over a vector column.

    ``get_nearest_items(query_embeddings, k)`` returns, per query row, tuples
    of the data table's columns for the k nearest vectors, nearest first;
    ``with_distances=True`` adds their scores as ``dist`` (the metric's score:
    minus the squared euclidean distance, or the cosine similarity)."""

    def __init__(
        self,
        data_embedding: expr.ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: expr.ColumnReference | None = None,
        exact: bool = True,
        approximate: str = "lsh",
        n_clusters: int = 64,
        n_probe: int = 8,
        device: Any = None,
    ):
        self.data = data
        if approximate not in ("lsh", "ivf"):
            raise ValueError(
                f"approximate={approximate!r} is not a KNNIndex mode; use 'lsh' or 'ivf'"
            )
        if exact and approximate != "lsh":
            # exact=True would silently shadow an explicit ANN request
            raise ValueError(
                f"approximate={approximate!r} requires exact=False "
                "(exact=True always builds the brute-force index)"
            )
        metric = (
            BruteForceKnnMetricKind.COS
            if distance_type == "cosine"
            else BruteForceKnnMetricKind.L2SQ
        )
        if exact:
            inner: Any = BruteForceKnn(
                data_embedding, metadata, dimensions=n_dimensions, metric=metric, device=device
            )
        elif approximate == "ivf":
            inner = IvfKnn(
                data_embedding,
                metadata,
                dimensions=n_dimensions,
                metric=metric,
                n_clusters=n_clusters,
                n_probe=n_probe,
                device=device,
            )
        else:
            inner = LshKnn(
                data_embedding,
                metadata,
                dimensions=n_dimensions,
                n_or=n_or,
                n_and=n_and,
                bucket_length=bucket_length,
                distance_type=distance_type,
                device=device,
            )
        self.index = DataIndex(data, inner)

    def get_nearest_items(
        self,
        query_embedding: expr.ColumnReference,
        k: Any = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: expr.ColumnExpression | None = None,
    ) -> Table:
        """Re-answered whenever the data changes."""
        result = self.index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        if with_distances:
            result = result.with_columns(dist=result._pw_index_reply_score)
        return result

    def get_nearest_items_asof_now(
        self,
        query_embedding: expr.ColumnReference,
        k: Any = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: expr.ColumnExpression | None = None,
    ) -> Table:
        """Answered once, against the data as of the query's arrival."""
        return self.index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
