"""ML stdlib (port of ``pathway_tpu/stdlib/ml``): ``KNNIndex``, the HMM
reducer, the fuzzy joins and the dataset loaders."""

from pathway_tpu_torch.stdlib.ml import datasets, hmm, index, smart_table_ops
from pathway_tpu_torch.stdlib.ml.index import KNNIndex
from pathway_tpu_torch.stdlib.ml.smart_table_ops import (
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_self_match,
    smart_fuzzy_match,
)

__all__ = [
    "KNNIndex",
    "datasets",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_self_match",
    "hmm",
    "index",
    "smart_fuzzy_match",
    "smart_table_ops",
]
