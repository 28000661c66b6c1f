"""A small HTTP layer on the standard library for the port's two apps.

The JAX package's admin and predictor apps are werkzeug WSGI apps;
werkzeug is absent on the card's machine, so the port's apps are plain
callables ``app(request) -> Response`` served by
``http.server.ThreadingHTTPServer``. This module holds what both need:
the :class:`Request` (body read by ``Content-Length``, query args,
JSON, urlencoded and multipart forms), the :class:`Response`, and a
server that runs an app on daemon request threads and releases its
socket on ``shutdown()`` + ``server_close()``.
"""

from __future__ import annotations

import email.parser
import email.policy
import functools
import json
import socketserver
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit


class Request:
    """One parsed HTTP request: ``method``, ``path`` (percent-decoded),
    ``args`` (query string, first value per key), ``headers`` (case-
    insensitive ``get``) and the raw ``body``."""

    def __init__(self, method: str, path: str, args: Dict[str, str],
                 headers, body: bytes):
        self.method = method
        self.path = path
        self.args = args
        self.headers = headers
        self.body = body

    @property
    def mimetype(self) -> str:
        return (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()

    def get_json(self) -> Any:
        """The body parsed as JSON whatever its content type, or None
        when it is not JSON (werkzeug's ``get_json(force=True,
        silent=True)``)."""
        try:
            return json.loads(self.body)
        except ValueError:
            return None

    @functools.cached_property
    def form(self) -> Tuple[Dict[str, str], Dict[str, bytes]]:
        """``(fields, files)`` of a urlencoded or multipart body."""
        if self.mimetype == "application/x-www-form-urlencoded":
            qs = parse_qs(self.body.decode("utf-8"), keep_blank_values=True)
            return {k: v[0] for k, v in qs.items()}, {}
        if self.mimetype != "multipart/form-data":
            return {}, {}
        head = f"Content-Type: {self.headers.get('Content-Type')}\r\n\r\n".encode()
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + self.body)
        fields: Dict[str, str] = {}
        files: Dict[str, bytes] = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            payload = part.get_payload(decode=True) or b""
            if part.get_filename() is not None:
                files[name] = payload
            else:
                fields[name] = payload.decode("utf-8")
        return fields, files


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data).encode(), status)


class _Handler(BaseHTTPRequestHandler):
    def _handle(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        url = urlsplit(self.path)
        args = {k: v[0] for k, v in parse_qs(url.query, keep_blank_values=True).items()}
        try:
            resp = self.server.app(Request(self.command, unquote(url.path), args,
                                           self.headers, body))
        except Exception as e:  # the apps answer their own errors; this is a backstop
            resp = json_response({"error": f"Internal error: {type(e).__name__}: {e}"}, 500)
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(resp.body)

    do_GET = do_POST = do_PUT = do_DELETE = _handle

    def log_message(self, format, *args) -> None:  # one line per request is noise here
        pass


class AppServer(ThreadingHTTPServer):
    """Serves ``app`` on a thread per request (daemon threads)."""

    daemon_threads = True

    def __init__(self, host: str, port: int, app: Callable[[Request], Response]):
        self.app = app
        super().__init__((host, port), _Handler)

    def server_bind(self) -> None:
        # HTTPServer.server_bind asks socket.getfqdn for a name it only
        # uses in CGI environments: skip the name lookup.
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]


def start_server(app: Callable[[Request], Response], host: str = "127.0.0.1",
                 port: int = 0, name: str = "http") -> Tuple[AppServer, threading.Thread]:
    """Serve ``app`` from a daemon thread; returns (server, thread).
    Stop with ``server.shutdown(); server.server_close()``."""
    server = AppServer(host, port, app)
    thread = threading.Thread(target=server.serve_forever, name=name, daemon=True)
    thread.start()
    return server, thread
