"""VectorStoreServer and VectorStoreClient (port of ``pathway_tpu/xpacks/llm/vector_store.py``).

Document rows + embedder → KNN index, served over REST at ``/v1/retrieve``,
``/v1/statistics`` and ``/v1/inputs`` with the reference's request and
response shapes. The client speaks the same routes with ``urllib``.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Callable, Dict, Iterable

from pathway_tpu_torch.io.http import JsonServer
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfKnnFactory,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


class VectorStoreServer:
    """Document sources + embedder → served KNN index.

    ``index_factory``: ``None`` (exact cosine search), ``"ivf"`` (IVF-Flat,
    cosine, whose page scorer is the CUDA kernel) or a factory object."""

    def __init__(
        self,
        *docs: Iterable[dict],
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
        self.store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        # the device path is not re-entrant across request threads
        self._lock = threading.Lock()

    @property
    def index(self) -> Any:
        return self.store.index

    def _retrieve(self, payload: Dict[str, Any]) -> list:
        request = {
            "query": str(payload["query"]),
            "k": 3 if payload.get("k") is None else int(payload["k"]),
            "metadata_filter": payload.get("metadata_filter"),
            "filepath_globpattern": payload.get("filepath_globpattern"),
        }
        with self._lock:
            return self.store.retrieve_many([request])[0]

    def _statistics(self, payload: Dict[str, Any]) -> dict:
        with self._lock:
            return self.store.statistics()

    def _inputs(self, payload: Dict[str, Any]) -> list:
        with self._lock:
            return self.store.inputs(
                payload.get("metadata_filter"), payload.get("filepath_globpattern")
            )

    def make_server(self, host: str = "0.0.0.0", port: int = 8000) -> JsonServer:
        return JsonServer(
            host,
            port,
            {
                "/v1/retrieve": self._retrieve,
                "/v1/statistics": self._statistics,
                "/v1/inputs": self._inputs,
            },
        )

    def run_server(
        self, host: str = "0.0.0.0", port: int = 8000, *, threaded: bool = False
    ) -> JsonServer | None:
        """Serve /v1/retrieve, /v1/statistics, /v1/inputs. ``threaded=True``
        returns the started :class:`JsonServer` (its ``port`` is the bound
        port, ``close()`` stops it); otherwise serves until interrupted."""
        server = self.make_server(host, port)
        if threaded:
            return server.start()
        try:
            server.serve_forever()
        finally:
            server.close()
        return None


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
