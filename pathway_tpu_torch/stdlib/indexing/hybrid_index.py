"""Hybrid retrieval with reciprocal-rank fusion (port of
``pathway_tpu/stdlib/indexing/hybrid_index.py``).

``HybridIndex`` asks each inner index (typically an embedding index and
BM25) for ``max(2 * limit, 10)`` answers and ranks the union by the sum of
``1 / (k + rank + 1)`` over the lists a key is in, as the reference does.

Two differences by design:

- ``HybridIndex.preprocess_data`` is a tuple of each inner index's own
  ``preprocess_data``, as its ``preprocess_query`` is. The reference leaves
  the data column raw, so a hybrid over an embedding index fails at the
  first document (``TypeError: expected a vector, got str``).
- ``_HybridInstance`` has ``add_many`` / ``search_many``: each inner
  instance gets its share of a commit in one call where it has one, so the
  IVF side of a commit's queries is one search on the card. The answers are
  the per-query fusion's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory


class _HybridInstance:
    """``add_seconds`` / ``search_seconds``: host seconds spent in each inner
    instance (the hybrid's split of the index operator's time)."""

    def __init__(self, instances: List[Any], k: float):
        self.instances = instances
        self.k = k
        self.add_seconds = [0.0] * len(instances)
        self.search_seconds = [0.0] * len(instances)

    def _split(self, value: Any) -> tuple:
        # one entry per inner index (e.g. (vector, text)), else the value for each
        if isinstance(value, tuple) and len(value) == len(self.instances):
            return value
        return (value,) * len(self.instances)

    def add(self, key: Any, value: Any, filter_data: Any = None) -> None:
        for i, (inst, v) in enumerate(zip(self.instances, self._split(value))):
            t0 = time.perf_counter()
            inst.add(key, v, filter_data)
            self.add_seconds[i] += time.perf_counter() - t0

    def add_many(self, keys: List[Any], values: List[Any], filter_data: List[Any] | None = None) -> None:
        split = [self._split(v) for v in values]
        for i, inst in enumerate(self.instances):
            t0 = time.perf_counter()
            share = [s[i] for s in split]
            if hasattr(inst, "add_many"):
                inst.add_many(keys, share, filter_data)
            else:
                for j, key in enumerate(keys):
                    inst.add(key, share[j], filter_data[j] if filter_data is not None else None)
            self.add_seconds[i] += time.perf_counter() - t0

    def remove(self, key: Any) -> None:
        for inst in self.instances:
            inst.remove(key)

    def search(self, query: Any, limit: int, filter_expr: Any = None) -> List[tuple]:
        return self.search_many([query], [limit], [filter_expr])[0]

    def search_many(
        self, queries: List[Any], limits: List[int], filter_exprs: List[Any] | None = None
    ) -> List[List[tuple]]:
        n = len(queries)
        filters = list(filter_exprs) if filter_exprs is not None else [None] * n
        asked = [max(int(limit) * 2, 10) for limit in limits]
        split = [self._split(q) for q in queries]
        answers = []  # per inner instance: per query, its (key, score) list
        for i, inst in enumerate(self.instances):
            t0 = time.perf_counter()
            share = [s[i] for s in split]
            if hasattr(inst, "search_many"):
                answers.append(inst.search_many(share, asked, filters))
            else:
                answers.append([inst.search(q, m, f) for q, m, f in zip(share, asked, filters)])
            self.search_seconds[i] += time.perf_counter() - t0
        out = []
        for qi in range(n):
            fused: Dict[Any, float] = {}
            for results in answers:
                for rank, (key, _score) in enumerate(results[qi]):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (self.k + rank + 1)
            ranked = sorted(fused.items(), key=lambda kv: -kv[1])[: int(limits[qi])]
            out.append([(key, score) for key, score in ranked])
        return out


class HybridIndex(InnerIndex):
    def __init__(self, inner_indexes: List[InnerIndex], *, k: float = 60.0):
        first = inner_indexes[0]
        super().__init__(first.data_column, first.metadata_column)
        self.inner_indexes = inner_indexes
        self.k = k

    def make_instance_factory(self) -> Any:
        factories = [ix.make_instance_factory() for ix in self.inner_indexes]
        k = self.k
        return lambda: _HybridInstance([f() for f in factories], k)

    def preprocess_query(self, query_column: expr.ColumnReference) -> expr.ColumnExpression:
        processed = [ix.preprocess_query(query_column) for ix in self.inner_indexes]
        return expr.make_tuple(*processed)

    def preprocess_data(self, data_column: expr.ColumnReference) -> expr.ColumnExpression:
        processed = [ix.preprocess_data(data_column) for ix in self.inner_indexes]
        return expr.make_tuple(*processed)


@dataclass
class HybridIndexFactory(AbstractRetrieverFactory):
    retriever_factories: List[AbstractRetrieverFactory] = field(default_factory=list)
    k: float = 60.0

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        inner = [f.build_inner_index(data_column, metadata_column) for f in self.retriever_factories]
        return HybridIndex(inner, k=self.k)

    def build_index(
        self,
        data_column: expr.ColumnReference,
        data_table: Table,
        metadata_column: expr.ColumnReference | None = None,
        **kwargs: Any,
    ) -> DataIndex:
        return _HybridDataIndex(data_table, self.build_inner_index(data_column, metadata_column))


class _HybridDataIndex(DataIndex):
    pass
