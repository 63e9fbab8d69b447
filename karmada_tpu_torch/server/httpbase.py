"""Shared plumbing for the JSON-over-HTTP services (control-plane apiserver,
scheduler shim, metrics server): one place for reply/read framing and the
background ThreadingHTTPServer lifecycle (the port's copy of
server/httpbase.py)."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class QuietHandler(BaseHTTPRequestHandler):
    """HTTP/1.1 handler with request logging off."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - intentionally quiet
        pass


def send_json(handler: BaseHTTPRequestHandler, status: int, body: dict,
              extra_headers: Optional[dict] = None) -> None:
    try:
        data = json.dumps(body).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            handler.send_header(k, v)
        if handler.close_connection:
            # drain_body declined an oversized body: tell the peer the
            # socket will not be reused (the unread bytes make it unusable)
            handler.send_header("Connection", "close")
        handler.end_headers()
        handler.wfile.write(data)
    except (BrokenPipeError, ConnectionResetError):
        pass


def read_json(handler: BaseHTTPRequestHandler) -> dict:
    """Request body as a dict. Accepts both negotiated body codecs: plain
    JSON (the default) and the binary framed message
    (`Content-Type: application/x-karmada-bin`, server/wirecodec.py) that
    clients upgrade to after seeing the advertise header — one sniff here
    makes EVERY POST route codec-transparent (batch writes, replication
    appends, the coalesced agent-status path)."""
    n = int(handler.headers.get("Content-Length") or 0)
    if n == 0:
        return {}
    raw = handler.rfile.read(n)
    from . import wirecodec

    if wirecodec.is_binary_content_type(
            handler.headers.get("Content-Type")):
        body = wirecodec.unpack_message(raw)
        if not isinstance(body, dict):
            raise wirecodec.WireProtocolError("message body must be a dict")
        return body
    return json.loads(raw.decode())


def wants_openmetrics(handler: BaseHTTPRequestHandler) -> bool:
    """Content negotiation for /metrics: exemplars are only legal in the
    openmetrics-text exposition, so they render only when the scraper's
    Accept header asks for it (Prometheus's own contract — a 0.0.4 parser
    fails the whole scrape on a mid-line '#')."""
    return "openmetrics-text" in handler.headers.get("Accept", "")


def send_prometheus(handler: BaseHTTPRequestHandler, text: str,
                    openmetrics: bool = False) -> None:
    """Prometheus text-exposition reply — the one place the content-type
    version and framing live (used by the apiserver /metrics route and the
    per-daemon MetricsServer)."""
    try:
        data = text.encode()
        handler.send_response(200)
        handler.send_header(
            "Content-Type",
            "application/openmetrics-text; version=1.0.0; charset=utf-8"
            if openmetrics else "text/plain; version=0.0.4; charset=utf-8")
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)
    except (BrokenPipeError, ConnectionResetError):
        pass


# an unauthenticated peer may drain at most this much; anything larger gets
# the connection torn down instead of read (the bytes were never paid for)
DRAIN_BODY_MAX = 1 << 20
_DRAIN_CHUNK = 64 * 1024


def drain_body(handler: BaseHTTPRequestHandler,
               max_bytes: int = DRAIN_BODY_MAX) -> None:
    """Consume an unread request body before an early-reply (401/404): on an
    HTTP/1.1 keep-alive connection, leftover body bytes would be parsed as
    the next request line, desyncing every later request on the socket.

    The body is discarded in fixed 64 KiB chunks — never allocated as one
    attacker-controlled Content-Length buffer — and a body above `max_bytes`
    is not read at all: the handler instead closes the connection after the
    reply (send_json adds `Connection: close`), so an unauthenticated peer
    cannot make the server read (or buffer) an arbitrarily large body."""
    try:
        n = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        handler.close_connection = True
        return
    if n <= 0:
        return
    if n > max_bytes:
        handler.close_connection = True
        return
    try:
        remaining = n
        while remaining > 0:
            chunk = handler.rfile.read(min(_DRAIN_CHUNK, remaining))
            if not chunk:
                break  # peer closed early; nothing left to desync
            remaining -= len(chunk)
    except OSError:
        handler.close_connection = True


# default server-side socket timeout: bounds how long ONE connection may sit
# between bytes (request line, headers, body, TLS handshake) before it is
# reaped — the slow-loris bound. Override per server via `socket_timeout`.
DEFAULT_SOCKET_TIMEOUT = 15.0


class _DetachMixin:
    """Socket hand-off seam for the event-loop watch plane: a handler that
    transplanted its connection (a dup()'d descriptor now owned by
    server/eventloop.py) calls `detach_request(self.connection)`; the
    per-request teardown then only closes THIS fd instead of issuing the
    usual `shutdown(SHUT_WR)` — which would FIN the shared connection and
    end the handed-off stream under the loop."""

    def detach_request(self, request) -> None:
        ids = getattr(self, "_detached_requests", None)
        if ids is None:
            ids = self._detached_requests = set()
        ids.add(id(request))

    def shutdown_request(self, request):  # noqa: D102 - socketserver hook
        ids = getattr(self, "_detached_requests", None)
        if ids is not None and id(request) in ids:
            ids.discard(id(request))
            self.close_request(request)
            return
        super().shutdown_request(request)


def make_http_server(host: str, port: int, handler_cls,
                     ssl_context=None,
                     socket_timeout: float = DEFAULT_SOCKET_TIMEOUT,
                     ) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer, TLS-wrapped per connection when ssl_context
    is given: the handshake runs in the handler thread (finish_request under
    ThreadingMixIn), NOT on the accept loop, so a client that connects and
    never sends ClientHello cannot stall every other request.

    `socket_timeout` applies to EVERY connection (plain or TLS): a peer that
    connects and trickles bytes — the slow-loris shape — is reaped after
    this many idle seconds instead of pinning a handler thread and socket
    forever (BaseHTTPRequestHandler treats the read timeout as end of
    requests and closes). 0/None disables (tests only)."""
    if socket_timeout:
        # per-connection timeout via the handler's `timeout` attribute
        # (socketserver applies it in setup(); handle_one_request maps the
        # resulting socket.timeout to close_connection)
        handler_cls = type(
            handler_cls.__name__, (handler_cls,),
            {"timeout": socket_timeout},
        )
    if ssl_context is None:
        class PlainServer(_DetachMixin, ThreadingHTTPServer):
            # accept backlog: the socketserver default of 5 turns a fleet
            # of agents reconnecting at once (control-plane restart, or W
            # writers opening a connection per request) into
            # connection-refused storms — writers then die or retry-spin.
            # 128 rides the kernel somaxconn clamp.
            request_queue_size = 128

        httpd = PlainServer((host, port), handler_cls)
    else:
        class TLSServer(_DetachMixin, ThreadingHTTPServer):
            request_queue_size = 128  # see PlainServer

            def finish_request(self, request, client_address):
                import ssl

                request.settimeout(socket_timeout or None)
                try:
                    tls = ssl_context.wrap_socket(request, server_side=True)
                    tls.settimeout(None)
                except (ssl.SSLError, OSError):
                    request.close()
                    return
                self.RequestHandlerClass(tls, client_address, self)

        httpd = TLSServer((host, port), handler_cls)
    httpd.daemon_threads = True
    return httpd


def bearer_auth_ok(handler: BaseHTTPRequestHandler,
                   token: Optional[str]) -> bool:
    """Constant-time bearer check; tolerant of hostile header bytes."""
    if token is None:
        return True
    import hmac

    supplied = handler.headers.get("Authorization", "")
    return hmac.compare_digest(
        supplied.encode("utf-8", "surrogateescape"),
        f"Bearer {token}".encode(),
    )


class BackgroundHTTPServer:
    """A ThreadingHTTPServer served from a daemon thread; `start()` returns
    the bound port (0 = ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None,
                 socket_timeout: float = DEFAULT_SOCKET_TIMEOUT):
        self._host = host
        self._port = port
        self._ssl_context = ssl_context
        self._socket_timeout = socket_timeout
        self._httpd: Optional[ThreadingHTTPServer] = None

    def bind(self, handler_cls, name: str) -> int:
        self.bind_only(handler_cls)
        return self.serve(name)

    def bind_only(self, handler_cls) -> ThreadingHTTPServer:
        self._httpd = make_http_server(
            self._host, self._port, handler_cls, self._ssl_context,
            socket_timeout=self._socket_timeout,
        )
        return self._httpd

    def serve(self, name: str) -> int:
        self._port = self._httpd.server_address[1]
        threading.Thread(
            target=self._httpd.serve_forever, name=name, daemon=True
        ).start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    @property
    def host(self) -> str:
        return self._host

    @property
    def scheme(self) -> str:
        return "https" if self._ssl_context is not None else "http"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
