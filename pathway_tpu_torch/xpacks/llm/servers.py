"""REST servers for RAG apps (port of ``pathway_tpu/xpacks/llm/servers.py``).

``BaseRestServer`` serves routes of a handler over ``rest_connector`` on
one ``PathwayWebserver``; ``DocumentStoreServer``, ``QARestServer`` and
``QASummaryRestServer`` serve the reference's routes. A route that embeds
its query (retrieve, answer) takes the admission of ``VectorStoreServer``:
at most ``PATHWAY_EMBED_MAX_PENDING`` (1,024) requests in flight and the
embed coalescer's queue probed first; past either it sheds with 429 and
``Retry-After``. :meth:`BaseRestServer.run` drives the engine (on a thread
with ``threaded=True``), :meth:`BaseRestServer.close` stops it.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any

from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


def _embedder_of(store: Any) -> Any:
    """The embedder of a store's retriever factory (or of the first of a
    hybrid's inner factories that has one)."""
    factory = getattr(store, "retriever_factory", None)
    for f in [factory, *getattr(factory, "retriever_factories", [])]:
        embedder = getattr(f, "embedder", None)
        if embedder is not None:
            return embedder
    return None


class BaseRestServer:
    """Routes of handlers over one webserver (``port=0`` binds a free port:
    ``self.webserver.port``). ``embedder``: the embedder whose queue the
    embed-bound routes probe before admission."""

    def __init__(self, host: str, port: int, *, embedder: Any = None, **rest_kwargs: Any):
        self.host = host
        self.webserver = PathwayWebserver(host=host, port=port, **rest_kwargs)
        self.port = self.webserver.port
        self.embedder = embedder
        self.routes: list[str] = []
        self.runner: Any = None
        self._thread: threading.Thread | None = None

    def _admission(self) -> dict:
        coalescer = getattr(getattr(self.embedder, "pipeline", None), "coalescer", None)
        return {
            "max_pending": int(os.environ.get("PATHWAY_EMBED_MAX_PENDING", "1024")),
            "shed_stage": "embed.shed",
            "retry_after": coalescer.retry_after_s if coalescer is not None else None,
            "overload_probe": coalescer.overloaded if coalescer is not None else None,
        }

    def serve(
        self,
        route: str,
        schema: type,
        handler: Any,
        *,
        methods: tuple = ("POST",),
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        embeds: bool = False,
        **additional_endpoint_kwargs: Any,
    ) -> None:
        """Serve ``handler(queries)`` at ``route``; ``embeds``: the route
        embeds its query and takes the embed admission."""
        if retry_strategy is not None or cache_strategy is not None:
            warnings.warn(
                "retry_strategy/cache_strategy on serve() are not applied yet; set them "
                "on the UDFs (e.g. OpenAIChat(retry_strategy=...)) instead",
                stacklevel=2,
            )
        extra = self._admission() if embeds else {}
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=methods,
            delete_completed_queries=True,
            **{**extra, **additional_endpoint_kwargs},
        )
        writer(handler(queries))
        self.routes.append(route)

    def run(
        self,
        *,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
        device: Any = None,
        **kwargs: Any,
    ) -> Any:
        """Drive the engine; with ``threaded=True`` on a daemon thread, which
        is returned once every route answers. ``device``: where the engine
        offloads device work (the embedder's device when not given).
        ``with_cache`` / ``cache_backend`` are accepted and unused: caches are
        set per UDF (``cache_strategy``), as in the reference."""
        from pathway_tpu_torch.engine.runner import GraphRunner
        from pathway_tpu_torch.internals.parse_graph import G

        if device is None:
            device = getattr(self.embedder, "device", None)
        self.runner = GraphRunner(G)

        def target() -> None:
            self.runner.run(terminate_on_error=terminate_on_error, device=device, **kwargs)

        if threaded:
            self._thread = threading.Thread(target=target, daemon=True, name="pathway:rest-server")
            self._thread.start()
            self.webserver.wait_for_routes(self.routes)
            return self._thread
        target()
        return None

    def close(self) -> None:
        """Stop serving: close the webserver, end the engine's run, join it."""
        self.webserver.close()
        if self.runner is not None:
            self.runner.stop()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None


class DocumentStoreServer(BaseRestServer):
    """``/v1/retrieve``, ``/v1/statistics`` and ``/v1/inputs`` of a
    ``DocumentStore``."""

    def __init__(self, host: str, port: int, document_store: Any, **rest_kwargs: Any):
        store = document_store.store if hasattr(document_store, "store") else document_store
        super().__init__(host, port, embedder=_embedder_of(store), **rest_kwargs)
        both = ("GET", "POST")
        self.serve(
            "/v1/retrieve", store.RetrieveQuerySchema, store.retrieve_query, methods=both,
            embeds=True,
        )
        self.serve("/v1/statistics", store.StatisticsQuerySchema, store.statistics_query, methods=both)
        self.serve("/v1/inputs", store.InputsQuerySchema, store.inputs_query, methods=both)


class QARestServer(BaseRestServer):
    """``/v1/pw_ai_answer``, ``/v2/answer``, ``/v1/retrieve``,
    ``/v2/list_documents`` and ``/v1/statistics`` of a question answerer."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **rest_kwargs: Any):
        qa = rag_question_answerer
        super().__init__(
            host, port, embedder=_embedder_of(getattr(qa, "indexer", None)), **rest_kwargs
        )
        both = ("GET", "POST")
        self.serve("/v1/pw_ai_answer", qa.AnswerQuerySchema, qa.answer_query, embeds=True)
        self.serve("/v2/answer", qa.AnswerQuerySchema, qa.answer_query, embeds=True)
        self.serve("/v1/retrieve", qa.RetrieveQuerySchema, qa.retrieve, methods=both, embeds=True)
        self.serve("/v2/list_documents", qa.InputsQuerySchema, qa.list_documents, methods=both)
        self.serve("/v1/statistics", qa.StatisticsQuerySchema, qa.statistics, methods=both)


class QASummaryRestServer(QARestServer):
    """The routes of ``QARestServer`` and ``/v1/pw_ai_summary``,
    ``/v2/summarize``."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **rest_kwargs: Any):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        qa = rag_question_answerer
        self.serve("/v1/pw_ai_summary", qa.SummarizeQuerySchema, qa.summarize_query)
        self.serve("/v2/summarize", qa.SummarizeQuerySchema, qa.summarize_query)
