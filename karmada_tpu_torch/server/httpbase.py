"""Plumbing of the JSON-over-HTTP services: reply/read framing, the
bearer check and the background ThreadingHTTPServer lifecycle.

A copy of what the scheduler shim uses of karmada_tpu/server/httpbase.py
(the watch plane's socket hand-off and the metrics replies serve the
control plane, which the port does not have yet).
"""
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


def send_json(handler: BaseHTTPRequestHandler, status: int, body: dict) -> None:
    try:
        data = json.dumps(body).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        if handler.close_connection:
            # drain_body declined an oversized body: tell the peer the
            # socket will not be reused (the unread bytes make it unusable)
            handler.send_header("Connection", "close")
        handler.end_headers()
        handler.wfile.write(data)
    except (BrokenPipeError, ConnectionResetError):
        pass


def read_json(handler: BaseHTTPRequestHandler) -> dict:
    """Request body as a dict, read to its full Content-Length. Accepts
    both negotiated body codecs: plain JSON (the default) and the binary
    framed message (`Content-Type: application/x-karmada-bin`,
    wirecodec.py)."""
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


# an unauthenticated peer may drain at most this much; anything larger gets
# the connection torn down instead of read (the bytes were never paid for)
DRAIN_BODY_MAX = 1 << 20
_DRAIN_CHUNK = 64 * 1024


def drain_body(handler: BaseHTTPRequestHandler) -> None:
    """Consume an unread request body before an early reply (401/404): on an
    HTTP/1.1 keep-alive connection, leftover body bytes would be parsed as
    the next request line, desyncing every later request on the socket.
    The body is discarded in fixed 64 KiB chunks, and a body above
    DRAIN_BODY_MAX is not read at all: the handler closes the connection after
    the reply instead (send_json adds `Connection: close`)."""
    try:
        n = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        handler.close_connection = True
        return
    if n <= 0:
        return
    if n > DRAIN_BODY_MAX:
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


# server-side socket timeout: bounds how long ONE connection may sit
# between bytes (request line, headers, body, TLS handshake) before it is
# reaped — the slow-loris bound
SOCKET_TIMEOUT = 15.0


def make_http_server(host: str, port: int, handler_cls,
                     ssl_context=None) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer, TLS-wrapped per connection when ssl_context
    is given: the handshake runs in the handler thread, not on the accept
    loop, so a client that connects and never sends ClientHello cannot
    stall every other request. SOCKET_TIMEOUT applies to every
    connection."""
    # per-connection timeout via the handler's `timeout` attribute
    handler_cls = type(
        handler_cls.__name__, (handler_cls,), {"timeout": SOCKET_TIMEOUT},
    )
    if ssl_context is None:
        class PlainServer(ThreadingHTTPServer):
            # accept backlog past socketserver's default of 5
            request_queue_size = 128

        httpd = PlainServer((host, port), handler_cls)
    else:
        class TLSServer(ThreadingHTTPServer):
            request_queue_size = 128

            def finish_request(self, request, client_address):
                import ssl

                request.settimeout(SOCKET_TIMEOUT)
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
    """A ThreadingHTTPServer served from a daemon thread; `bind()` returns
    the bound port (0 = ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self._host = host
        self._port = port
        self._ssl_context = ssl_context
        self._httpd: Optional[ThreadingHTTPServer] = None

    def bind(self, handler_cls, name: str) -> int:
        self._httpd = make_http_server(
            self._host, self._port, handler_cls, self._ssl_context,
        )
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
