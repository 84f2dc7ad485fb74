"""REST connector (port of ``pathway_tpu/io/http/_server.py``).

The webserver turns each HTTP request into a row of a streaming table (the
query table); a response writer subscribes to a result table and answers the
request whose query row produced the result. ``PathwayWebserver`` runs on the
port's stdlib JSON server (``_json_server.py``): a request waits on its own
thread until the engine answers it.

Admission, before a request's row is pushed: while the brownout ladder's
quiesce window is open the route answers 429; past ``max_pending`` requests
in flight (tightened by the ladder's ``admission_scale``), or while
``overload_probe`` reports a full downstream queue, it sheds with 429 and
``Retry-After: retry_after_int(retry_after())``, counted on ``shed_stage``
and per ``X-Pathway-Client``. Every route's schema goes into the server's
OpenAPI v3 document, served at ``openapi_docs_path`` (``/_schema``) as the
reference's is.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Callable, Dict, Sequence

from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.brownout import get_brownout, retry_after_int
from pathway_tpu_torch.engine.datasource import StreamingDataSource
from pathway_tpu_torch.engine.profile import histogram
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json, jsonable_value
from pathway_tpu_torch.internals.keys import Pointer, pointer_from
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http._json_server import ClientGone, JsonServer, Reply, Request

# distinct client ids a route counts sheds for before folding into "other"
_MAX_SHED_CLIENTS = 32


def _client_id(headers: Any) -> "str | None":
    """The ``X-Pathway-Client`` header, cut to 32 characters of letters,
    digits, ``-`` and ``_`` (it names a stage counter)."""
    try:
        raw = headers.get("X-Pathway-Client")
    except Exception:
        return None
    if not raw:
        return None
    cleaned = "".join(c for c in str(raw)[:32] if c.isalnum() or c in "-_")
    return cleaned or None


class EndpointDocumentation:
    """A route's entry in the OpenAPI v3 document: summary, description,
    tags and the methods documented (all by default)."""

    DEFAULT_RESPONSES = {
        "200": {"description": "OK"},
        "400": {
            "description": "The request is incorrect. Please check if it complies "
            "with the endpoint's input schema"
        },
    }

    def __init__(
        self,
        *,
        summary: str | None = None,
        description: str | None = None,
        tags: Sequence[str] | None = None,
        method_types: Sequence[str] | None = None,
    ):
        self.summary = summary
        self.description = description
        self.tags = list(tags) if tags else None
        self.method_types = (
            {m.upper() for m in method_types} if method_types is not None else None
        )

    def generate_docs(self, method: str, schema: Any) -> dict | None:
        method = method.upper()
        if self.method_types is not None and method not in self.method_types:
            return None
        entry: dict = {"responses": dict(self.DEFAULT_RESPONSES)}
        if self.summary:
            entry["summary"] = self.summary
        if self.description:
            entry["description"] = self.description
        if self.tags:
            entry["tags"] = self.tags
        properties, required = _openapi_schema_fields(schema)
        if method == "GET":
            entry["parameters"] = [
                {"name": name, "in": "query", "required": name in required, "schema": spec}
                for name, spec in properties.items()
            ]
        else:
            entry["requestBody"] = {
                "content": {
                    "application/json": {
                        "schema": {
                            "type": "object",
                            "properties": properties,
                            "required": sorted(required),
                        }
                    }
                },
                "required": True,
            }
        return entry


def _openapi_schema_fields(schema: Any) -> tuple[dict, set]:
    """Each column's OpenAPI type (and default), and the required columns:
    those neither optional nor with a default."""
    type_map = {
        dt.INT: {"type": "integer"},
        dt.FLOAT: {"type": "number"},
        dt.BOOL: {"type": "boolean"},
        dt.STR: {"type": "string"},
        dt.JSON: {"type": "object"},
        dt.BYTES: {"type": "string", "format": "binary"},
    }
    properties: dict = {}
    required: set = set()
    for name, col in schema.columns().items():
        base = col.dtype.strip_optional()
        properties[name] = dict(type_map.get(base, {"type": "string"}))
        if col.has_default:
            if col.default_value is not None and col.default_value is not ...:
                properties[name]["default"] = col.default_value
        elif col.dtype == base:
            required.add(name)
    return properties, required


class PathwayWebserver:
    """One HTTP server shared by any number of ``rest_connector`` routes. It
    binds when built (``port=0`` binds a free port; :attr:`port` is the bound
    one); a route answers once its query table's source has started.
    ``openapi_docs_path`` (``None`` for none) answers the OpenAPI v3
    document of every route registered. :meth:`close` stops it and closes
    its query tables' sources. ``with_cors`` is accepted and unused."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8080,
        with_cors: bool = False,
        openapi_docs_path: str | None = "/_schema",
    ):
        self.host = host
        self.with_cors = with_cors
        self.openapi_docs_path = openapi_docs_path
        # (method, route) -> (schema, documentation)
        self._docs: Dict[tuple, tuple] = {}
        routes = {}
        if openapi_docs_path is not None:
            routes[openapi_docs_path] = lambda _request: self.openapi_description()
        self._server = JsonServer(host, port, routes).start()
        self.port = self._server.port
        self.closed = threading.Event()
        self._routes_changed = threading.Condition()
        # route -> its RestServerSubject (admission state: in-flight requests, sheds)
        self.subjects: Dict[str, "RestServerSubject"] = {}

    def _register_docs(
        self,
        route: str,
        methods: Sequence[str],
        schema: Any,
        documentation: "EndpointDocumentation | None" = None,
    ) -> None:
        if route == self.openapi_docs_path:
            raise ValueError(
                f"route {route!r} collides with the OpenAPI docs endpoint; pass "
                "openapi_docs_path=None (or another path) to PathwayWebserver"
            )
        for method in methods:
            self._docs[(method.upper(), route)] = (schema, documentation or EndpointDocumentation())

    def openapi_description(self) -> dict:
        """The OpenAPI v3 document covering every documented route."""
        paths: dict = {}
        for (method, route), (schema, docs) in sorted(self._docs.items()):
            entry = docs.generate_docs(method, schema)
            if entry is None:
                continue
            paths.setdefault(route, {})[method.lower()] = entry
        return {
            "openapi": "3.0.3",
            "info": {"title": "Pathway-TPU API", "version": "1.0.0"},
            "servers": [{"url": f"http://{self.host}:{self.port}"}],
            "paths": paths,
        }

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
        max_pending: int = 0,
        shed_stage: str = "rest.shed",
        retry_after: Callable[[], float] | None = None,
        overload_probe: Callable[[], bool] | None = None,
    ):
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self.futures: Dict[Pointer, concurrent.futures.Future] = {}
        # requests pushed into the engine and not yet answered; past
        # max_pending (0 = unbounded) new ones are shed
        self.max_pending = max(0, int(max_pending))
        self.shed_stage = shed_stage
        self._retry_after = retry_after
        self._overload_probe = overload_probe
        self.shed_requests = 0
        # sheds per X-Pathway-Client, at most _MAX_SHED_CLIENTS ids (the
        # header is the client's to choose), the rest under "other"
        self.shed_by_client: Dict[str, int] = {}
        self._counter = 0
        self._lock = threading.Lock()

    def _shed(self, request: Request, probe_hit: bool, cap: int, level: int) -> Reply:
        client = _client_id(request.headers)
        with self._lock:
            self.shed_requests += 1
            if client is not None:
                if client not in self.shed_by_client and len(self.shed_by_client) >= _MAX_SHED_CLIENTS:
                    client = "other"
                self.shed_by_client[client] = self.shed_by_client.get(client, 0) + 1
            in_flight = len(self.futures)
        telemetry.stage_add(self.shed_stage)
        if client is not None:
            telemetry.stage_add(f"{self.shed_stage}.client.{client}")
        retry_s = 1.0
        if self._retry_after is not None:
            try:
                retry_s = float(self._retry_after())
            except Exception:
                pass
        if probe_hit:
            reason = "downstream embed queue full"
        else:
            reason = f"{in_flight} requests in flight (cap {cap}" + (
                f", tightened by brownout rung {level})" if level else ")"
            )
        return Reply(
            429,
            {"error": f"overloaded: {reason}; retry after the indicated delay"},
            {"Retry-After": retry_after_int(retry_s)},
        )

    def run(self, source: StreamingDataSource) -> None:
        def handler(request: Request) -> Any:
            payload = request.payload
            if self.request_validator is not None:
                self.request_validator(payload)  # raises: the request is refused (400)
            brownout = get_brownout()
            # the commit loop is paused: an admitted request would hang
            quiesce_s = brownout.quiesce_retry_after()
            if quiesce_s is not None:
                telemetry.stage_add("rest.quiesce_shed")
                return Reply(
                    429,
                    {"error": "the engine is paused at a commit boundary; "
                              "retry after the indicated delay"},
                    {"Retry-After": retry_after_int(quiesce_s)},
                )
            probe_hit = False
            if self._overload_probe is not None:
                try:
                    probe_hit = bool(self._overload_probe())
                except Exception:
                    probe_hit = False
            cap, level = self.max_pending, 0
            if self.max_pending:
                scale = brownout.admission_scale()
                if scale < 1.0:
                    level = brownout.level()
                    cap = max(1, int(self.max_pending * scale))
            key = None
            future: concurrent.futures.Future = concurrent.futures.Future()
            with self._lock:
                # shed before the push: a shed request costs only this answer
                if not probe_hit and not (cap and len(self.futures) >= cap):
                    self._counter += 1
                    key = pointer_from(self._counter, self.route, "rest")
                    self.futures[key] = future
            if key is None:
                return self._shed(request, probe_hit, cap, level)
            pushed = False
            try:
                row = {}
                for name, col in self.schema.columns().items():
                    v = payload.get(name, col.default_value if col.has_default else None)
                    if col.dtype.strip_optional() == dt.JSON and v is not None and not isinstance(v, Json):
                        v = Json(v)
                    row[name] = v
                t0 = time.perf_counter()
                source.push(row, key=key, diff=1)
                pushed = True
                while True:
                    try:
                        result = future.result(timeout=0.25)
                        break
                    except concurrent.futures.TimeoutError:
                        if request.client_gone():
                            raise ClientGone() from None
                        if self.webserver.closed.is_set():
                            raise RuntimeError("the server closed before the engine answered")
                # the serving-path latency histogram (/metrics exports it next
                # to commit duration): push -> engine commit -> future resolution
                histogram("pathway_rest_latency_seconds").observe(time.perf_counter() - t0)
                return result
            finally:
                # a failed or dropped request releases its admission slot
                with self._lock:
                    self.futures.pop(key, None)
                if self.delete_completed_queries and pushed:
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
    keep_queries: bool | None = None,
    delete_completed_queries: bool = False,
    request_validator: Any = None,
    documentation: "EndpointDocumentation | None" = None,
    max_pending: int = 0,
    shed_stage: str = "rest.shed",
    retry_after: "Callable[[], float] | None" = None,
    overload_probe: "Callable[[], bool] | None" = None,
) -> tuple[Table, Any]:
    """Expose an HTTP endpoint as a streaming table; returns (queries,
    response_writer). ``max_pending`` caps the route's requests in flight
    (0 = unbounded): past it, or while ``overload_probe()`` reports a full
    downstream queue, a request is shed with 429 and a ``Retry-After`` from
    ``retry_after()`` (1 s without it), counted on the stage counter
    ``shed_stage``. ``documentation``: the route's entry in the server's
    OpenAPI document. ``keep_queries`` is accepted and unused, as in the
    reference."""
    if webserver is None:
        webserver = PathwayWebserver(host=host or "0.0.0.0", port=port or 8080)
    if schema is None:
        schema = sch.schema_from_types(query=str)
    webserver._register_docs(route, methods, schema, documentation)
    subject = RestServerSubject(
        webserver, route, methods, schema, delete_completed_queries, request_validator,
        max_pending=max_pending, shed_stage=shed_stage, retry_after=retry_after,
        overload_probe=overload_probe,
    )
    webserver.subjects[route] = subject
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
