"""DocumentStore (port of ``pathway_tpu/xpacks/llm/document_store.py``).

The reference runs the pipeline on its dataflow engine over ``pw.Table``s.
The port has no engine yet: it runs the same parse → post-process → split →
embed → index steps as a host-side batch over a list of document rows
``{"data": bytes | str, "_metadata": dict}``, and answers the same queries
with the same payloads.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from pathway_tpu_torch.internals.json import Json


def _as_dict(meta: Any) -> dict:
    if isinstance(meta, Json):
        meta = meta.value
    return dict(meta) if isinstance(meta, dict) else {}


class DocumentStore:
    """Documents → chunks → embeddings → index, plus the query surface
    ``retrieve`` / ``statistics`` / ``inputs``."""

    def __init__(
        self,
        docs: Iterable[dict] | Iterable[Iterable[dict]],
        retriever_factory: Any,
        parser: Any = None,
        splitter: Any = None,
        doc_post_processors: list[Callable] | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        self.retriever_factory = retriever_factory
        self.embedder = getattr(retriever_factory, "embedder", None)
        self.parser = parser if parser is not None else ParseUtf8()
        self.splitter = splitter if splitter is not None else NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.input_docs: List[dict] = []
        self.chunk_texts: List[str] = []
        self.chunk_meta: List[dict] = []
        self.ingest_seconds: Dict[str, float] = {}
        self.index = retriever_factory.build_index()
        self.add_documents(docs)

    # -- ingest -------------------------------------------------------------

    def _chunks_of(self, doc: dict) -> List[tuple]:
        input_meta = _as_dict(doc.get("_metadata"))
        out = []
        for text, parse_meta in self.parser.func(doc["data"]):
            meta = {**input_meta, **_as_dict(parse_meta)}
            for post in self.doc_post_processors:
                text = post(text)
            for chunk, chunk_meta in self.splitter.func(text, meta):
                if len(chunk) > 0:
                    out.append((chunk, _as_dict(chunk_meta)))
        return out

    def add_documents(self, docs: Iterable[Any]) -> None:
        """Parse, split, embed and index a batch of documents (one embed
        pipeline pass and one bulk index insert for the batch), then build
        the index so the first query pays no training. Host seconds per
        stage accumulate in :attr:`ingest_seconds`."""
        t0 = time.perf_counter()
        rows: List[dict] = []
        for d in docs:
            if isinstance(d, dict):
                rows.append(d)
            else:  # one source = an iterable of rows
                rows.extend(d)
        texts: List[str] = []
        metas: List[dict] = []
        for doc in rows:
            self.input_docs.append(doc)
            for chunk, meta in self._chunks_of(doc):
                texts.append(chunk)
                metas.append(meta)
        t1 = time.perf_counter()
        t2 = t1
        if texts:
            vecs = self.embedder(texts)
            t2 = time.perf_counter()
            base = len(self.chunk_texts)
            keys = list(range(base, base + len(texts)))
            self.chunk_texts.extend(texts)
            self.chunk_meta.extend(metas)
            self.index.add_many(keys, vecs, filter_data=metas)
        t3 = time.perf_counter()
        self.index.build()
        t4 = time.perf_counter()
        for stage, dt in (
            ("parse_split", t1 - t0), ("embed", t2 - t1), ("index_add", t3 - t2),
            ("index_build", t4 - t3),
        ):
            self.ingest_seconds[stage] = self.ingest_seconds.get(stage, 0.0) + dt

    # -- queries ------------------------------------------------------------

    def retrieve(
        self,
        query: str,
        k: int = 3,
        metadata_filter: Optional[str] = None,
        filepath_globpattern: Optional[str] = None,
    ) -> list:
        return self.retrieve_many([
            {"query": query, "k": k, "metadata_filter": metadata_filter,
             "filepath_globpattern": filepath_globpattern}
        ])[0]

    def retrieve_many(self, requests: List[Dict[str, Any]]) -> List[list]:
        """Answer a batch of retrieve requests with one query embed and one
        index search: ``[{"text", "metadata", "dist"}, ...]`` per request,
        best first, ``dist = -score``."""
        if not requests:
            return []
        queries = [str(r["query"]) for r in requests]
        ks = [3 if r.get("k") is None else int(r["k"]) for r in requests]
        filters = [
            _combined_filter(r.get("metadata_filter"), r.get("filepath_globpattern"))
            for r in requests
        ]
        qvecs = self.embedder.embed_queries(queries)
        hits = self.index.search_many(qvecs, ks, filters)
        return [
            _format_retrieved(
                [self.chunk_texts[key] for key, _ in res],
                [self.chunk_meta[key] for key, _ in res],
                [score for _, score in res],
            )
            for res in hits
        ]

    def statistics(self) -> dict:
        metas = [_as_dict(d.get("_metadata")) for d in self.input_docs]
        modified = [m["modified_at"] for m in metas if m.get("modified_at") is not None]
        seen = [m["seen_at"] for m in metas if m.get("seen_at") is not None]
        payload: Dict[str, Any] = {
            "file_count": len(self.input_docs),
            "last_modified": max(modified) if modified else None,
            "last_indexed": max(seen) if seen else None,
        }
        stats_fn = getattr(self.embedder, "pipeline_stats", None)
        if stats_fn is not None:
            payload["embedder"] = stats_fn()
        return payload

    def inputs(
        self, metadata_filter: Optional[str] = None, filepath_globpattern: Optional[str] = None
    ) -> list:
        """Metadata of every input document (the filters are accepted and, as
        in the reference, not applied)."""
        return [_as_dict(d.get("_metadata")) for d in self.input_docs]


def _combined_filter(metadata_filter: Any, globpattern: Any) -> str | None:
    parts = []
    if metadata_filter:
        parts.append(f"({metadata_filter})")
    if globpattern:
        escaped = str(globpattern).replace("'", "\\'")
        parts.append(f"globmatch('{escaped}', path)")
    return " && ".join(parts) if parts else None


def _format_retrieved(texts: list, metadatas: list, scores: list) -> list:
    return [
        {"text": text, "metadata": meta, "dist": -float(score)}
        for text, meta, score in zip(texts, metadatas, scores)
    ]
