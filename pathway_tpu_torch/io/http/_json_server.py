"""A small threaded JSON-over-HTTP server: the transport of the port's REST plane.

Stands in for the reference's aiohttp server with the standard library only
(``http.server.ThreadingHTTPServer``). Each route is a function of a
:class:`Request` (the JSON object of a POST body or of a GET's query string,
the request headers, and a probe for a client that hung up) that returns a
JSON-serialisable answer (status 200) or a :class:`Reply` with a status and
headers of its own; it runs on the request's own thread. A route that
raises :class:`ClientGone` gets no answer written. ``port=0`` binds a free
port; :attr:`JsonServer.port` is the port actually bound.
"""

from __future__ import annotations

import json
import select
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Mapping, Optional

from pathway_tpu_torch.internals.json import jsonable_value


class Request:
    """What a route sees of one HTTP request."""

    __slots__ = ("payload", "headers", "_conn")

    def __init__(self, payload: Dict[str, Any], headers: Mapping[str, str], conn: Any = None):
        self.payload = payload
        self.headers = headers  # case-insensitive .get for the server's requests
        self._conn = conn

    def client_gone(self) -> bool:
        """True once the client closed its connection (it reads as end of
        stream with nothing pending)."""
        if self._conn is None:
            return False
        try:
            readable, _w, _x = select.select([self._conn], [], [], 0)
            return bool(readable) and self._conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True


class Reply:
    """A route's answer with a status and headers of its own."""

    __slots__ = ("status", "payload", "headers")

    def __init__(self, status: int, payload: Any, headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.payload = payload
        self.headers = headers or {}


class ClientGone(Exception):
    """Raised by a route whose client hung up: nothing is written back."""


Route = Callable[[Request], Any]


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002 - base signature
        pass  # quiet: a request log line per query would dominate the output

    def _reply(self, code: int, payload: Any, headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(jsonable_value(payload)).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, payload: Dict[str, Any]) -> None:
        path = urllib.parse.urlsplit(self.path).path
        route = self.server.routes.get(path)
        if route is None:
            self._reply(404, {"error": f"no route {path}"})
            return
        try:
            answer = route(Request(payload, self.headers, self.connection))
        except ClientGone:
            self.close_connection = True
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        except Exception as exc:  # the server must keep serving other requests
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        if isinstance(answer, Reply):
            self._reply(answer.status, answer.payload, answer.headers)
        else:
            self._reply(200, answer)

    def do_GET(self) -> None:  # noqa: N802 - http.server naming
        query = urllib.parse.urlsplit(self.path).query
        self._dispatch({k: v[-1] for k, v in urllib.parse.parse_qs(query).items()})

    def do_POST(self) -> None:  # noqa: N802 - http.server naming
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        try:
            payload = json.loads(raw) if raw.strip() else {}
        except json.JSONDecodeError as exc:
            self._reply(400, {"error": f"bad JSON body: {exc}"})
            return
        if not isinstance(payload, dict):
            self._reply(400, {"error": "the JSON body must be an object"})
            return
        self._dispatch(payload)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: with the default of 5, a burst of concurrent clients
    # overflows it and their connection attempts wait for the kernel's SYN
    # retry (1 s, then 3 s)
    request_queue_size = 1024
    routes: Dict[str, Route]


class JsonServer:
    """Serve ``routes`` (path → function) on ``host:port``."""

    def __init__(self, host: str, port: int, routes: Dict[str, Route]):
        self._httpd = _Server((host, port), _Handler)
        self._httpd.routes = dict(routes)
        self.routes = self._httpd.routes  # routes may be added while serving
        self.host = host
        self.thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start(self) -> "JsonServer":
        """Serve on a daemon thread and return at once."""
        self.thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="pathway-torch:http"
        )
        self.thread.start()
        return self

    def close(self) -> None:
        """Stop serving, join the thread and release the socket."""
        if self.thread is not None:
            self._httpd.shutdown()
            self.thread.join(timeout=10)
            self.thread = None
        self._httpd.server_close()
