"""DataIndex / InnerIndex — typed index querying over tables
(port of ``pathway_tpu/stdlib/indexing/data_index.py``).

The query path compiles to the engine's external-index operator
(``engine/evaluators.py::ExternalIndexEvaluator``); the KNN search runs on
the device (``ops/knn.py``, ``ops/knn_ivf.py``).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


class InnerIndex:
    """Engine-facing index description: data column + factory for per-worker instances."""

    def __init__(
        self,
        data_column: expr.ColumnReference,
        metadata_column: expr.ColumnReference | None = None,
    ):
        self.data_column = data_column
        self.metadata_column = metadata_column

    def make_instance_factory(self) -> Any:
        raise NotImplementedError

    def preprocess_query(self, query_column: expr.ColumnReference) -> expr.ColumnExpression:
        """Hook: e.g. embed text queries before the index sees them."""
        return query_column

    def preprocess_data(self, data_column: expr.ColumnReference) -> expr.ColumnExpression:
        """Hook: e.g. embed indexed documents (text column → vector column)."""
        return data_column


class _InstanceFactory:
    def __init__(self, make: Callable[[], Any]):
        self._make = make

    def make_instance(self) -> Any:
        return self._make()


class DataIndex:
    """Index over ``data_table``; querying returns per-query matched rows.

    ``query_as_of_now`` gives as-of-now semantics (answers never retracted on index change;
    used by RAG serving); ``query`` re-answers queries when the index updates.
    """

    def __init__(
        self,
        data_table: Table,
        inner_index: InnerIndex,
    ):
        self.data_table = data_table
        self.inner_index = inner_index
        # build the (possibly embedded) index-side table ONCE: every query surface shares
        # it, so the corpus crosses the embedder a single time per document update
        self._index_table = data_table.select(
            _pw_vec=inner_index.preprocess_data(inner_index.data_column),
            **(
                {"_pw_meta": inner_index.metadata_column}
                if inner_index.metadata_column is not None
                else {}
            ),
        )

    def query_as_of_now(
        self,
        query_column: expr.ColumnReference,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: expr.ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
            as_of_now=True,
        )

    def query(
        self,
        query_column: expr.ColumnReference,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: expr.ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
            as_of_now=False,
        )

    def _query(
        self,
        query_column: expr.ColumnReference,
        *,
        number_of_matches: Any,
        collapse_rows: bool,
        metadata_filter: expr.ColumnExpression | None,
        as_of_now: bool,
    ) -> Table:
        queries = query_column.table
        processed_query = self.inner_index.preprocess_query(query_column)
        query_table = queries.select(
            _pw_query=processed_query,
            _pw_limit=number_of_matches,
            **(
                {"_pw_qfilter": metadata_filter}
                if metadata_filter is not None
                else {}
            ),
        )
        index_table = self._index_table
        reply = query_table._external_index_as_of_now(
            index_table,
            index_column=index_table._pw_vec,
            query_column=query_table._pw_query,
            index_factory=_InstanceFactory(self.inner_index.make_instance_factory()),
            res_type=dt.ANY,
            query_responses_limit_column=query_table._pw_limit,
            index_filter_data_column=(
                index_table._pw_meta if self.inner_index.metadata_column is not None else None
            ),
            query_filter_column=(
                query_table._pw_qfilter if metadata_filter is not None else None
            ),
            asof_now=as_of_now,
        )
        # reply: per query key, tuple of (data_key, score)
        if not collapse_rows:
            flat = reply.flatten(reply._pw_index_reply, origin_id="_pw_query_id")
            matched = flat.select(
                _pw_query_id=flat._pw_query_id,
                _pw_match_ptr=flat._pw_index_reply[0],
                _pw_index_reply_score=flat._pw_index_reply[1],
            )
            data_cols = {
                name: self.data_table.ix(matched._pw_match_ptr)[name]
                for name in self.data_table.column_names()
            }
            return matched.select(
                matched._pw_query_id, matched._pw_index_reply_score, **data_cols
            )

        flat = reply.flatten(reply._pw_index_reply, origin_id="_pw_query_id")
        matched = flat.select(
            _pw_query_id=flat._pw_query_id,
            _pw_match_ptr=flat._pw_index_reply[0],
            _pw_score=flat._pw_index_reply[1],
        )
        data_rows = self.data_table.ix(matched._pw_match_ptr)
        enriched_cols = {
            name: data_rows[name] for name in self.data_table.column_names()
        }
        enriched = matched.select(
            matched._pw_query_id, matched._pw_score, **enriched_cols
        )
        grouped = enriched.groupby(enriched._pw_query_id).reduce(
            enriched._pw_query_id,
            _pw_index_reply_score=reducers.tuple(
                enriched._pw_score, sort_by=-enriched._pw_score
            ),
            **{
                name: reducers.tuple(enriched[name], sort_by=-enriched._pw_score)
                for name in self.data_table.column_names()
            },
        )
        rekeyed = grouped.with_id(grouped._pw_query_id).without("_pw_query_id")
        # left-join back (keyed by the query id) so zero-match queries still produce a row
        joined = queries.join_left(rekeyed, queries.id == rekeyed.id, id=queries.id).select(
            *[queries[n] for n in queries.column_names()],
            **{
                "_pw_index_reply_score": expr.coalesce(
                    rekeyed._pw_index_reply_score, expr.make_tuple()
                ),
            },
            **{
                name: expr.coalesce(rekeyed[name], expr.make_tuple())
                for name in self.data_table.column_names()
            },
        )
        return joined
