"""KNN inner indexes & factories (port of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``).

A factory builds a ``DataIndex`` over a table; the engine's external-index
operator makes the keyed index (``BruteForceKnnIndex`` / ``IvfKnnIndex``
from ``ops/knn.py``) and feeds it the table's rows. Defaults match the
reference: L2SQ metric, 1024 reserved slots, IVF with 64 clusters and 8
probes. ``device``: where the index lives (the embedder's device when not
given; the card unless ``"cpu"``). ``LshKnn`` is the reference's
random-projection LSH index. ``USearchKnn`` keeps the reference's HNSW
index's API and, as the reference does, serves it exactly from the dense
store (no ``usearch`` package). The ``default_*_knn_document_index``
helpers build a ``DataIndex`` over one of them.
"""

from __future__ import annotations

import enum
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory


class BruteForceKnnMetricKind(enum.Enum):
    L2SQ = "l2sq"
    COS = "cos"
    IP = "ip"


class USearchMetricKind(enum.Enum):
    L2SQ = "l2sq"
    COS = "cos"
    IP = "ip"


def _metric_str(metric: Any) -> str:
    if isinstance(metric, enum.Enum):
        return str(metric.value)
    return str(metric)


class _KnnInnerIndex(InnerIndex):
    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None,
        embedder: Any,
        make_index: Callable[[], Any],
    ):
        super().__init__(data_column, metadata_column)
        self.embedder = embedder
        self._make_index = make_index

    def make_instance_factory(self) -> Callable[[], Any]:
        return self._make_index

    def preprocess_query(self, query_column: expr.ColumnReference) -> expr.ColumnExpression:
        """Query embeddings stay on the device (``device_expression``) and
        chain into the search without a host round trip."""
        if self.embedder is None:
            return query_column
        device = getattr(self.embedder, "device_expression", None)
        if device is not None:
            return device(query_column)
        return self.embedder(query_column)

    def preprocess_data(self, data_column: expr.ColumnReference) -> expr.ColumnExpression:
        if self.embedder is not None:
            return self.embedder(data_column)
        return data_column


def _index_device(embedder: Any, device: Any) -> Any:
    if device is None and embedder is not None:
        device = getattr(embedder, "device", None)
    return device


class BruteForceKnn(_KnnInnerIndex):
    """Exact KNN over the dense device store. ``auxiliary_space`` is
    accepted and unused, as in the reference: the store grows by doubling."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        auxiliary_space: int = 1024,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.L2SQ,
        embedder: Any = None,
        device: Any = None,
    ):
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

        metric_s = _metric_str(metric)
        dev = _index_device(embedder, device)
        super().__init__(
            data_column,
            metadata_column,
            embedder,
            lambda: BruteForceKnnIndex(
                dimensions, metric=metric_s, initial_capacity=max(16, reserved_space), device=dev
            ),
        )


class USearchKnn(BruteForceKnn):
    """The reference's HNSW index's API, served exactly by the dense store
    (as the reference serves it); ``connectivity`` and the expansions are
    accepted and unused."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        metric: USearchMetricKind = USearchMetricKind.COS,
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        embedder: Any = None,
        device: Any = None,
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
            device=device,
        )


class IvfKnn(_KnnInnerIndex):
    """Approximate KNN via IVF-Flat; its page scorer is the CUDA kernel
    ``csrc/score_pages.cu``. ``n_probe == n_clusters`` is exact search."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        n_clusters: int = 64,
        n_probe: int = 8,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.L2SQ,
        embedder: Any = None,
        device: Any = None,
    ):
        from pathway_tpu_torch.ops.knn import IvfKnnIndex

        metric_s = _metric_str(metric)
        dev = _index_device(embedder, device)
        super().__init__(
            data_column,
            metadata_column,
            embedder,
            lambda: IvfKnnIndex(
                dimensions,
                metric=metric_s,
                initial_capacity=max(16, reserved_space),
                n_clusters=n_clusters,
                n_probe=n_probe,
                device=dev,
            ),
        )


class LshKnn(_KnnInnerIndex):
    """Approximate KNN via random-projection LSH: bucket intersection on the
    host, the candidates' exact re-rank on the device."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
        *,
        dimensions: int,
        n_or: int = 8,
        n_and: int = 4,
        bucket_length: float = 4.0,
        distance_type: str = "euclidean",
        embedder: Any = None,
        device: Any = None,
    ):
        from pathway_tpu_torch.ops.knn import LshKnnIndex

        metric = "cos" if distance_type == "cosine" else "l2sq"
        dev = _index_device(embedder, device)
        super().__init__(
            data_column,
            metadata_column,
            embedder,
            lambda: LshKnnIndex(
                dimensions,
                metric=metric,
                bucket_length=bucket_length,
                n_or=n_or,
                n_and=n_and,
                device=dev,
            ),
        )


def _probe_embedder_dims(embedder: Any) -> int:
    """The embedder's width: ``get_embedding_dimension()``, else the length
    of its embedding of ``"test"``."""
    if hasattr(embedder, "get_embedding_dimension"):
        return int(embedder.get_embedding_dimension())
    if hasattr(embedder, "__wrapped__"):
        return len(embedder.__wrapped__("test"))
    func = getattr(embedder, "func", None)
    if func is not None:
        import asyncio

        result = func("test")
        if asyncio.iscoroutine(result):
            result = asyncio.run(result)
        return len(result)
    raise ValueError("cannot determine embedder dimensionality")


class BruteForceKnnFactory(AbstractRetrieverFactory):
    """Exact KNN over the dense device store."""

    def __init__(
        self,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        auxiliary_space: int = 1024,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.L2SQ,
        embedder: Any = None,
        device: Any = None,
    ):
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.auxiliary_space = auxiliary_space
        self.metric = metric
        self.embedder = embedder
        self.device = device

    def _dims(self) -> int:
        dims = self.dimensions
        if dims is None and self.embedder is not None:
            dims = _probe_embedder_dims(self.embedder)
        if dims is None:
            raise ValueError("dimensions required (or an embedder to ask)")
        return dims

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self._dims(),
            reserved_space=self.reserved_space,
            auxiliary_space=self.auxiliary_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )

    def build_index(
        self,
        data_column: expr.ColumnReference,
        data_table: Table,
        metadata_column: expr.ColumnReference | None = None,
        **kwargs: Any,
    ) -> DataIndex:
        return DataIndex(data_table, self.build_inner_index(data_column, metadata_column))


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

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        return IvfKnn(
            data_column,
            metadata_column,
            dimensions=self._dims(),
            reserved_space=self.reserved_space,
            n_clusters=self.n_clusters,
            n_probe=self.n_probe,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


class UsearchKnnFactory(BruteForceKnnFactory):
    """``USearchKnn`` over the dense store (metric COS by default)."""

    def __init__(
        self,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: USearchMetricKind = USearchMetricKind.COS,
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
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

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        return USearchKnn(
            data_column,
            metadata_column,
            dimensions=self._dims(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


USearchKnnFactory = UsearchKnnFactory


class LshKnnFactory(BruteForceKnnFactory):
    """Random-projection LSH (``LshKnn``)."""

    def __init__(
        self,
        *,
        dimensions: int | None = None,
        n_or: int = 8,
        n_and: int = 4,
        bucket_length: float = 4.0,
        distance_type: str = "euclidean",
        embedder: Any = None,
        device: Any = None,
    ):
        super().__init__(dimensions=dimensions, embedder=embedder, device=device)
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length
        self.distance_type = distance_type

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        return LshKnn(
            data_column,
            metadata_column,
            dimensions=self._dims(),
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            embedder=self.embedder,
            device=self.device,
        )


def default_brute_force_knn_document_index(
    data_column: expr.ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any = None,
    metadata_column: expr.ColumnReference | None = None,
    metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.COS,
    device: Any = None,
) -> DataIndex:
    return DataIndex(
        data_table,
        BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=dimensions,
            metric=metric,
            embedder=embedder,
            device=device,
        ),
    )


def default_usearch_knn_document_index(
    data_column: expr.ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any = None,
    metadata_column: expr.ColumnReference | None = None,
    metric: USearchMetricKind = USearchMetricKind.COS,
    device: Any = None,
) -> DataIndex:
    return DataIndex(
        data_table,
        USearchKnn(
            data_column,
            metadata_column,
            dimensions=dimensions,
            metric=metric,
            embedder=embedder,
            device=device,
        ),
    )


def default_lsh_knn_document_index(
    data_column: expr.ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any = None,
    metadata_column: expr.ColumnReference | None = None,
    device: Any = None,
) -> DataIndex:
    return DataIndex(
        data_table,
        LshKnn(data_column, metadata_column, dimensions=dimensions, embedder=embedder,
               device=device),
    )
