"""Fuzzy-matching table ops (port of ``pathway_tpu/stdlib/ml/smart_table_ops``)."""

from pathway_tpu_torch.stdlib.ml.smart_table_ops._fuzzy_join import (
    FuzzyJoinFeatureGeneration,
    FuzzyJoinNormalization,
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_self_match,
    smart_fuzzy_match,
)

__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_self_match",
    "smart_fuzzy_match",
]
