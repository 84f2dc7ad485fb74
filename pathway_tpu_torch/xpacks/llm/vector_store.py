"""VectorStoreServer and VectorStoreClient (port of ``pathway_tpu/xpacks/llm/vector_store.py``).

Document tables + embedder → KNN index, served over REST at ``/v1/retrieve``,
``/v1/statistics`` and ``/v1/inputs`` with the reference's request and
response shapes. Each request enters the engine as a row of a query table
(``rest_connector``) and is answered as of now by the ``DocumentStore``
graph. The client speaks the same routes with ``urllib``.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request
from typing import Any, Callable, Dict

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfKnnFactory,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


class VectorStoreServer:
    """Document tables + embedder → served KNN index.

    ``index_factory``: ``None`` (exact cosine search), ``"ivf"`` (IVF-Flat,
    cosine, whose page scorer is the CUDA kernel) or a factory object."""

    def __init__(
        self,
        *docs: Table,
        embedder: Any,
        parser: Any = None,
        splitter: Any = None,
        doc_post_processors: list[Callable] | None = None,
        index_factory: Any = None,
    ):
        self.embedder = embedder
        if index_factory is None:
            index_factory = BruteForceKnnFactory(
                embedder=embedder, metric=BruteForceKnnMetricKind.COS
            )
        elif index_factory == "ivf":
            index_factory = IvfKnnFactory(embedder=embedder, metric=BruteForceKnnMetricKind.COS)
        self.docs = list(docs)
        self.store = DocumentStore(
            self.docs,
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        self.webserver: Any = None
        self.runner: Any = None
        self._thread: threading.Thread | None = None

    class QuerySchema(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3, dtype=int)
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    class StatisticsSchema(pw.Schema):
        pass

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    def retrieve_query(self, queries: Table) -> Table:
        return self.store.retrieve_query(queries)

    def statistics_query(self, queries: Table) -> Table:
        return self.store.statistics_query(queries)

    def inputs_query(self, queries: Table) -> Table:
        return self.store.inputs_query(queries)

    @property
    def index(self) -> Any:
        return self.store.index

    def run_server(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        *,
        threaded: bool = False,
        terminate_on_error: bool = True,
        with_http_server: bool = False,
    ) -> Any:
        """Serve /v1/retrieve, /v1/statistics, /v1/inputs through the engine.
        ``port=0`` binds a free port (``self.webserver.port``). With
        ``threaded=True`` the engine runs on a daemon thread, which is
        returned once the routes answer; :meth:`close` stops it.
        ``with_http_server``: the engine's monitoring endpoint (``/metrics``,
        ``/status``, ``/healthz``) on ``PATHWAY_MONITORING_HTTP_PORT``
        (default 20000), as ``pw.run(with_http_server=True)``."""
        from pathway_tpu_torch.engine.runner import GraphRunner
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

        self.webserver = webserver = PathwayWebserver(host=host, port=port)
        # retrieve is the embed-bound route: at most PATHWAY_EMBED_MAX_PENDING
        # requests in flight, and the coalescer's row-queue cap probed before
        # admission; past either it sheds (429 + Retry-After, "embed.shed")
        coalescer = getattr(getattr(self.embedder, "pipeline", None), "coalescer", None)
        admission = {
            "max_pending": int(os.environ.get("PATHWAY_EMBED_MAX_PENDING", "1024")),
            "shed_stage": "embed.shed",
            "retry_after": coalescer.retry_after_s if coalescer is not None else None,
            "overload_probe": coalescer.overloaded if coalescer is not None else None,
        }
        routes = (
            ("/v1/retrieve", self.QuerySchema, self.retrieve_query, admission),
            ("/v1/statistics", self.StatisticsSchema, self.statistics_query, {}),
            ("/v1/inputs", self.InputsQuerySchema, self.inputs_query, {}),
        )
        for route, schema, answer, extra in routes:
            queries, writer = rest_connector(
                webserver=webserver,
                route=route,
                schema=schema,
                methods=("GET", "POST"),
                delete_completed_queries=True,
                **extra,
            )
            writer(answer(queries))
        self.runner = GraphRunner(G)

        def run() -> None:
            self.runner.run(
                terminate_on_error=terminate_on_error,
                device=getattr(self.embedder, "device", None),
                with_http_server=with_http_server,
            )

        if threaded:
            self._thread = threading.Thread(target=run, daemon=True, name="pathway:vector-server")
            self._thread.start()
            webserver.wait_for_routes([route for route, *_rest in routes])
            return self._thread
        run()
        return None

    def close(self) -> None:
        """Stop serving: close the webserver, end the engine's run, join it."""
        if self.webserver is not None:
            self.webserver.close()
        if self.runner is not None:
            self.runner.stop()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None


class VectorStoreClient:
    """HTTP client for VectorStoreServer."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int = 15,
        additional_headers: dict | None = None,
    ):
        self.url = url if url is not None else f"http://{host}:{port}"
        self.timeout = timeout
        self.headers = {"Content-Type": "application/json", **(additional_headers or {})}

    def _post(self, route: str, data: dict) -> Any:
        req = urllib.request.Request(
            self.url + route, data=json.dumps(data).encode(), headers=self.headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list:
        data: Dict[str, Any] = {"query": query, "k": k}
        if metadata_filter is not None:
            data["metadata_filter"] = metadata_filter
        if filepath_globpattern is not None:
            data["filepath_globpattern"] = filepath_globpattern
        return self._post("/v1/retrieve", data)

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self, metadata_filter: str | None = None, filepath_globpattern: str | None = None
    ) -> list:
        return self._post(
            "/v1/inputs",
            {"metadata_filter": metadata_filter, "filepath_globpattern": filepath_globpattern},
        )
