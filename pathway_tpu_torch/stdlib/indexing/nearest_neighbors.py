"""KNN index factories (port of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``).

The reference's factories wrap an engine ``DataIndex``; the port has no
engine yet, so ``build_index`` returns the keyed index itself
(``BruteForceKnnIndex`` / ``IvfKnnIndex`` from ``ops/knn.py``). Defaults match
the reference: L2SQ metric, 1024 reserved slots, IVF with 64 clusters and 8
probes.
"""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, IvfKnnIndex


class BruteForceKnnMetricKind(enum.Enum):
    L2SQ = "l2sq"
    COS = "cos"
    IP = "ip"


def _metric_str(metric: Any) -> str:
    if isinstance(metric, enum.Enum):
        return str(metric.value)
    return str(metric)


class BruteForceKnnFactory:
    """Exact KNN over the dense device store."""

    def __init__(
        self,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.L2SQ,
        embedder: Any = None,
        device: Any = None,
    ):
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.embedder = embedder
        self.device = device

    def _dims_and_device(self) -> tuple:
        dims = self.dimensions
        if dims is None and self.embedder is not None:
            dims = int(self.embedder.get_embedding_dimension())
        if dims is None:
            raise ValueError("dimensions required (or an embedder to ask)")
        device = self.device
        if device is None and self.embedder is not None:
            device = getattr(self.embedder, "device", None)
        return dims, device

    def build_index(self) -> BruteForceKnnIndex:
        dims, device = self._dims_and_device()
        return BruteForceKnnIndex(
            dims,
            metric=_metric_str(self.metric),
            initial_capacity=max(16, self.reserved_space),
            device=device,
        )


class IvfKnnFactory(BruteForceKnnFactory):
    """Approximate KNN via IVF-Flat; ``n_probe == n_clusters`` is exact."""

    def __init__(
        self,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        n_clusters: int = 64,
        n_probe: int = 8,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.L2SQ,
        embedder: Any = None,
        device: Any = None,
    ):
        super().__init__(
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
            device=device,
        )
        self.n_clusters = n_clusters
        self.n_probe = n_probe

    def build_index(self) -> IvfKnnIndex:
        dims, device = self._dims_and_device()
        return IvfKnnIndex(
            dims,
            metric=_metric_str(self.metric),
            initial_capacity=max(16, self.reserved_space),
            n_clusters=self.n_clusters,
            n_probe=self.n_probe,
            device=device,
        )
