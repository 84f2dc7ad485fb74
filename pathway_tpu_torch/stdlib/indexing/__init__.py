from pathway_tpu_torch.stdlib.indexing.filters import matches_filter
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfKnnFactory,
)

__all__ = [
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "IvfKnnFactory",
    "matches_filter",
]
