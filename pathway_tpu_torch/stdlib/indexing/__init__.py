"""Index stdlib (port of ``pathway_tpu/stdlib/indexing``)."""

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.filters import matches_filter
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex, HybridIndexFactory
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfKnn,
    IvfKnnFactory,
    LshKnn,
    LshKnnFactory,
    USearchKnn,
    USearchKnnFactory,
    USearchMetricKind,
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory
from pathway_tpu_torch.stdlib.indexing.sorting import (
    SortedIndex,
    build_sorted_index,
    retrieve_prev_next_values,
    sort_from_index,
)
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_vector_document_index,
)

__all__ = [
    "AbstractRetrieverFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "DataIndex",
    "HybridIndex",
    "HybridIndexFactory",
    "InnerIndex",
    "IvfKnn",
    "IvfKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "SortedIndex",
    "TantivyBM25",
    "TantivyBM25Factory",
    "USearchKnn",
    "USearchKnnFactory",
    "USearchMetricKind",
    "build_sorted_index",
    "default_brute_force_knn_document_index",
    "default_full_text_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "default_vector_document_index",
    "matches_filter",
    "retrieve_prev_next_values",
    "sort_from_index",
]
