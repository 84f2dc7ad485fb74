"""REST connector (port of ``pathway_tpu/io/http/_server.py``).

The webserver turns each HTTP request into a row of a streaming table (the
query table); a response writer subscribes to a result table and answers the
request whose query row produced the result. ``PathwayWebserver`` runs on the
port's stdlib JSON server (``_json_server.py``): a request waits on its own
thread until the engine answers it. The reference's admission shedding
(``max_pending``, ``overload_probe``, ``retry_after``) and OpenAPI document
are not ported.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Any, Dict, Sequence

from pathway_tpu_torch.engine.datasource import StreamingDataSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json, jsonable_value
from pathway_tpu_torch.internals.keys import Pointer, pointer_from
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http._json_server import JsonServer


class PathwayWebserver:
    """One HTTP server shared by any number of ``rest_connector`` routes. It
    binds when built (``port=0`` binds a free port; :attr:`port` is the bound
    one); a route answers once its query table's source has started.
    :meth:`close` stops it and closes its query tables' sources."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080):
        self.host = host
        self._server = JsonServer(host, port, {}).start()
        self.port = self._server.port
        self.closed = threading.Event()
        self._routes_changed = threading.Condition()

    def _register(self, route: str, methods: Sequence[str], handler: Any) -> None:
        with self._routes_changed:
            self._server.routes[route] = handler
            self._routes_changed.notify_all()

    def wait_for_routes(self, routes: Sequence[str], timeout: float = 60.0) -> None:
        """Block until every route in ``routes`` answers."""
        with self._routes_changed:
            if not self._routes_changed.wait_for(
                lambda: all(r in self._server.routes for r in routes), timeout
            ):
                raise TimeoutError(f"routes {list(routes)} did not start within {timeout}s")

    @property
    def url(self) -> str:
        return self._server.url

    def close(self) -> None:
        self.closed.set()
        self._server.close()


class RestServerSubject:
    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: Sequence[str],
        schema: sch.SchemaMetaclass,
        delete_completed_queries: bool,
        request_validator: Any = None,
    ):
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self.futures: Dict[Pointer, concurrent.futures.Future] = {}
        self._counter = 0
        self._lock = threading.Lock()

    def run(self, source: StreamingDataSource) -> None:
        def handler(payload: Dict[str, Any]) -> Any:
            if self.request_validator is not None:
                self.request_validator(payload)  # raises: the request is refused (400)
            with self._lock:
                self._counter += 1
                qid = self._counter
            key = pointer_from(qid, self.route, "rest")
            future: concurrent.futures.Future = concurrent.futures.Future()
            self.futures[key] = future
            row = {}
            for name, col in self.schema.columns().items():
                v = payload.get(name, col.default_value if col.has_default else None)
                if col.dtype.strip_optional() == dt.JSON and v is not None and not isinstance(v, Json):
                    v = Json(v)
                row[name] = v
            source.push(row, key=key, diff=1)
            try:
                return future.result()
            finally:
                self.futures.pop(key, None)
                if self.delete_completed_queries:
                    source.push(row, key=key, diff=-1)

        self.webserver._register(self.route, self.methods, handler)
        # the query table stays open while the server serves
        self.webserver.closed.wait()

    def resolve(self, key: Pointer, result: Any) -> None:
        future = self.futures.get(key)
        if future is not None and not future.done():
            future.set_result(result)


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: sch.SchemaMetaclass | None = None,
    methods: Sequence[str] = ("POST",),
    # serving path: a 1 ms commit tick makes per-request latency wake + commit;
    # requests arriving while one commit runs batch into the next
    autocommit_duration_ms: int | None = 1,
    delete_completed_queries: bool = False,
    request_validator: Any = None,
) -> tuple[Table, Any]:
    """Expose an HTTP endpoint as a streaming table; returns (queries, response_writer)."""
    if webserver is None:
        webserver = PathwayWebserver(host=host or "0.0.0.0", port=port or 8080)
    if schema is None:
        schema = sch.schema_from_types(query=str)
    subject = RestServerSubject(
        webserver, route, methods, schema, delete_completed_queries, request_validator
    )
    source = StreamingDataSource(subject=subject, autocommit_ms=autocommit_duration_ms)
    node = G.add_node(pg.InputNode(source=source, streaming=True, name=f"rest:{route}"))
    queries = Table(node, schema, name="rest_queries")

    def response_writer(result_table: Table, result_column: str = "result") -> None:
        def on_change(key: Pointer, row: dict, time: int, is_addition: bool) -> None:
            if is_addition:
                subject.resolve(key, jsonable_value(row.get(result_column)))

        from pathway_tpu_torch.io._subscribe import subscribe

        subscribe(result_table, on_change)

    return queries, response_writer
