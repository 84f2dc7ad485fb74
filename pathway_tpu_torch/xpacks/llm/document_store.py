"""DocumentStore (port of ``pathway_tpu/xpacks/llm/document_store.py``).

Document tables → parse → post-process → split → embed → index, as a graph
of the port's engine, and the query surface ``retrieve_query`` /
``statistics_query`` / ``inputs_query`` over query tables, with the
reference's request and response schemas. A document pushed again under the
same key replaces its chunks in the index; a removed one leaves it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory


class DocumentStore:
    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3, dtype=int)
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory,
        parser: Any = None,
        splitter: Any = None,
        doc_post_processors: list[Callable] | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        self.docs = [docs] if isinstance(docs, Table) else list(docs)
        if not self.docs:
            raise ValueError(
                "DocumentStore requires at least one document source table"
            )
        self.retriever_factory = retriever_factory
        self.parser = parser if parser is not None else ParseUtf8()
        self.splitter = splitter if splitter is not None else NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self._build_graph()

    # -- pipeline -----------------------------------------------------------

    def _build_graph(self) -> None:
        docs = self.docs[0] if len(self.docs) == 1 else self.docs[0].concat_reindex(
            *self.docs[1:]
        )
        if "_metadata" not in docs.column_names():
            docs = docs.with_columns(_metadata=expr.apply_with_type(lambda: Json({}), dt.JSON))
        self.input_docs = docs

        # parse: data -> [(text, meta)]
        parsed = docs.select(
            _pw_parsed=self.parser(docs.data),
            _pw_input_meta=docs._metadata,
        )
        flat = parsed.flatten(parsed._pw_parsed, origin_id="_pw_doc_id")
        parsed_docs = flat.select(
            text=flat._pw_parsed[0],
            metadata=expr.apply_with_type(
                _merge_meta, dt.JSON, flat._pw_input_meta, flat._pw_parsed[1]
            ),
        )
        for post in self.doc_post_processors:
            parsed_docs = parsed_docs.select(
                text=expr.apply_with_type(post, str, parsed_docs.text),
                metadata=parsed_docs.metadata,
            )
        self.parsed_docs = parsed_docs

        # split: text -> [(chunk, meta)]
        splitted = parsed_docs.select(
            _pw_chunks=self.splitter(parsed_docs.text, parsed_docs.metadata),
        )
        chunk_flat = splitted.flatten(splitted._pw_chunks, origin_id="_pw_parsed_id")
        chunked_docs = chunk_flat.select(
            text=chunk_flat._pw_chunks[0],
            metadata=expr.apply_with_type(
                lambda m: m if isinstance(m, Json) else Json(m if m is not None else {}),
                dt.JSON,
                chunk_flat._pw_chunks[1],
            ),
        )
        self.chunked_docs = chunked_docs.filter(chunked_docs.text.str.len() > 0)

        self.index = self.retriever_factory.build_index(
            self.chunked_docs.text,
            self.chunked_docs,
            metadata_column=self.chunked_docs.metadata,
        )

    # -- queries ------------------------------------------------------------

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """queries(query, k, metadata_filter, filepath_globpattern) → result column."""
        names = retrieval_queries.column_names()
        queries = retrieval_queries.select(
            query=retrieval_queries.query,
            k=expr.coalesce(retrieval_queries.k, 3) if "k" in names else 3,
            _pw_filter=expr.apply_with_type(
                _combined_filter,
                dt.Optional_(dt.STR),
                retrieval_queries.metadata_filter if "metadata_filter" in names else None,
                retrieval_queries.filepath_globpattern
                if "filepath_globpattern" in names
                else None,
            ),
        )
        result = self.index.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            collapse_rows=True,
            metadata_filter=queries._pw_filter,
        )
        return result.select(
            result=expr.apply_with_type(
                _format_retrieved,
                dt.JSON,
                result.text,
                result.metadata,
                result._pw_index_reply_score,
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        counted = self.input_docs.reduce(
            count=reducers.count(),
            last_modified=reducers.max(
                expr.apply_with_type(_modified_ts, dt.Optional_(dt.INT), self.input_docs._metadata)
            ),
            last_indexed=reducers.max(
                expr.apply_with_type(_seen_ts, dt.Optional_(dt.INT), self.input_docs._metadata)
            ),
        )

        def _payload(c: Any, m: Any, i: Any) -> Json:
            payload = {"file_count": c or 0, "last_modified": m, "last_indexed": i}
            # live embed-pipeline counters (caches, coalescer, service, pad
            # waste) when the embedder exposes them, read at answer time; a
            # failing read leaves the key out and never fails the commit
            stats_fn = getattr(
                getattr(self.retriever_factory, "embedder", None), "pipeline_stats", None
            )
            if stats_fn is not None:
                try:
                    payload["embedder"] = stats_fn()
                except Exception:
                    pass
            # the same snapshot /metrics exports: commit latency percentiles
            # and the top operators by cumulative wall time
            # (engine/profile.py). Pinned per commit: every re-derivation
            # within one commit must see the same value (a value that moved
            # between two evaluations of the same row churns update pairs);
            # the next commit reads fresh
            try:
                from pathway_tpu_torch.engine.expression_evaluator import get_runtime
                from pathway_tpu_torch.engine.profile import get_profiler

                token = get_runtime().get("commit_token")
                if token is None or getattr(self, "_engine_snapshot_token", None) != token:
                    self._engine_snapshot_cache = get_profiler().snapshot()
                    self._engine_snapshot_token = token
                payload["engine"] = self._engine_snapshot_cache
            except Exception:
                pass
            return Json(payload)

        joined = info_queries.join_left(counted, id=info_queries.id).select(
            result=expr.apply_with_type(
                _payload,
                dt.JSON,
                counted.count,
                counted.last_modified,
                counted.last_indexed,
            )
        )
        return joined

    def inputs_query(self, input_queries: Table) -> Table:
        files = self.input_docs.reduce(
            metadatas=reducers.tuple(self.input_docs._metadata)
        )
        joined = input_queries.join_left(files, id=input_queries.id).select(
            result=expr.apply_with_type(
                lambda metas: Json(
                    [m.value if isinstance(m, Json) else m for m in (metas or ())]
                ),
                dt.JSON,
                files.metadatas,
            )
        )
        return joined

    retrieve = retrieve_query
    statistics = statistics_query
    inputs = inputs_query


def _merge_meta(input_meta: Any, parse_meta: Any) -> Json:
    out = {}
    if isinstance(input_meta, Json):
        value = input_meta.value
        if isinstance(value, dict):
            out.update(value)
    elif isinstance(input_meta, dict):
        out.update(input_meta)
    if isinstance(parse_meta, Json):
        parse_meta = parse_meta.value
    if isinstance(parse_meta, dict):
        out.update(parse_meta)
    return Json(out)


def _combined_filter(metadata_filter: Any, globpattern: Any) -> str | None:
    parts = []
    if metadata_filter:
        parts.append(f"({metadata_filter})")
    if globpattern:
        escaped = str(globpattern).replace("'", "\\'")
        parts.append(f"globmatch('{escaped}', path)")
    return " && ".join(parts) if parts else None


def _format_retrieved(texts: tuple, metadatas: tuple, scores: tuple) -> Json:
    out = []
    for text, meta, score in zip(texts, metadatas, scores):
        out.append(
            {
                "text": text,
                "metadata": meta.value if isinstance(meta, Json) else meta,
                "dist": -float(score),
            }
        )
    return Json(out)


def _modified_ts(meta: Any) -> int | None:
    if isinstance(meta, Json) and isinstance(meta.value, dict):
        return meta.value.get("modified_at")
    return None


def _seen_ts(meta: Any) -> int | None:
    if isinstance(meta, Json) and isinstance(meta.value, dict):
        return meta.value.get("seen_at")
    return None
