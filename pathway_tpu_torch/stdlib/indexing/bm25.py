"""Full-text BM25 index (port of ``pathway_tpu/stdlib/indexing/bm25.py``).

``TantivyBM25`` keeps the reference's name and API; as in the reference it
is a host-side inverted index with removals (text scoring is pointer
chasing over postings: host work). Scores are the reference's bit for bit:
the same tokenizer and the same float operations in the same order.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.filters import matches_filter
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def _tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text or "")]


class BM25Index:
    """Incremental BM25 inverted index with removals (k1/b per the standard formula)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.postings: Dict[str, Dict[Any, int]] = defaultdict(dict)
        self.doc_len: Dict[Any, int] = {}
        self.doc_tokens: Dict[Any, Counter] = {}
        self.filter_data: Dict[Any, Any] = {}
        self.total_len = 0

    def add(self, key: Any, text: Any, filter_data: Any = None) -> None:
        if key in self.doc_len:
            self.remove(key)
        tokens = Counter(_tokenize(str(text)))
        self.doc_tokens[key] = tokens
        n = sum(tokens.values())
        self.doc_len[key] = n
        self.total_len += n
        for term, count in tokens.items():
            self.postings[term][key] = count
        if filter_data is not None:
            self.filter_data[key] = filter_data

    def remove(self, key: Any) -> None:
        tokens = self.doc_tokens.pop(key, None)
        if tokens is None:
            return
        self.total_len -= self.doc_len.pop(key)
        for term in tokens:
            self.postings[term].pop(key, None)
            if not self.postings[term]:
                del self.postings[term]
        self.filter_data.pop(key, None)

    def search(self, query: Any, limit: int, filter_expr: Any = None) -> List[tuple]:
        n_docs = len(self.doc_len)
        if n_docs == 0:
            return []
        avg_len = self.total_len / n_docs
        scores: Dict[Any, float] = defaultdict(float)
        for term in _tokenize(str(query)):
            posting = self.postings.get(term)
            if not posting:
                continue
            idf = math.log(1 + (n_docs - len(posting) + 0.5) / (len(posting) + 0.5))
            for key, tf in posting.items():
                denom = tf + self.k1 * (1 - self.b + self.b * self.doc_len[key] / avg_len)
                scores[key] += idf * tf * (self.k1 + 1) / denom
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        out = []
        for key, score in ranked:
            if filter_expr is not None and not matches_filter(
                self.filter_data.get(key), filter_expr
            ):
                continue
            out.append((key, float(score)))
            if len(out) >= limit:
                break
        return out


class TantivyBM25(InnerIndex):
    """BM25 inner index (the reference's name and arguments; ``ram_budget``
    and ``in_memory_index`` are accepted and unused)."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
    ):
        super().__init__(data_column, metadata_column)

    def make_instance_factory(self) -> Any:
        return lambda: BM25Index()


@dataclass
class TantivyBM25Factory(AbstractRetrieverFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ) -> InnerIndex:
        return TantivyBM25(
            data_column,
            metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )

    def build_index(
        self,
        data_column: expr.ColumnReference,
        data_table: Table,
        metadata_column: expr.ColumnReference | None = None,
        **kwargs: Any,
    ) -> DataIndex:
        return DataIndex(data_table, self.build_inner_index(data_column, metadata_column))
