"""Per-daemon observability surface: GET /metrics (+ /healthz); the port's
copy of server/metricsserver.py.

The serving plane exposes /metrics on the apiserver itself; the scheduler,
descheduler, and agent daemons have no API surface of their own, so each
gets this sidecar HTTP server (reference: every binary serves
metrics+healthz via sharedcli). /metrics accepts either the daemon's wire
bearer token or a DEDICATED READ-ONLY scrape token (`scrape_token` /
--scrape-token-file): the Prometheus credential no longer has to be the
full wire token, so a compromised scraper cannot mutate the plane
(docs/HA.md). /healthz stays open for liveness probes, like the
apiserver's.
"""
from __future__ import annotations

from typing import Optional

from ..metrics import registry
from .httpbase import (
    BackgroundHTTPServer,
    QuietHandler,
    bearer_auth_ok,
    send_json,
    send_prometheus,
    wants_openmetrics,
)


def scrape_auth_ok(handler, token: Optional[str],
                   scrape_token: Optional[str]) -> bool:
    """Auth for a metrics route: the wire token OR the read-only scrape
    token. With neither configured the route is open (loopback default)."""
    if token is None and scrape_token is None:
        return True
    if token is not None and bearer_auth_ok(handler, token):
        return True
    return scrape_token is not None and bearer_auth_ok(handler, scrape_token)


class MetricsServer(BackgroundHTTPServer):
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None,
                 scrape_token: Optional[str] = None):
        super().__init__(host=host, port=port)
        self._token = token
        self._scrape_token = scrape_token

    def start(self) -> int:
        token = self._token
        scrape_token = self._scrape_token

        class Handler(QuietHandler):
            def do_GET(self) -> None:
                if self.path == "/healthz":
                    send_json(self, 200, {"ok": True})
                    return
                if not scrape_auth_ok(self, token, scrape_token):
                    send_json(self, 401, {"error": "unauthorized"})
                    return
                if self.path.split("?", 1)[0] != "/metrics":
                    send_json(self, 404, {"error": f"no route {self.path}"})
                    return
                om = wants_openmetrics(self)
                send_prometheus(self, registry.render(exemplars=om),
                                openmetrics=om)

        return self.bind(Handler, "metrics-server")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"


def start_metrics_server(port: int, host: str = "127.0.0.1",
                         token: Optional[str] = None,
                         scrape_token: Optional[str] = None,
                         scrape_token_file: str = "",
                         ) -> Optional[MetricsServer]:
    """Daemon-main helper: port < 0 disables; 0 binds an ephemeral port.
    Prints the scrape URL so callers (and ha_smoke.sh) can find it.
    `scrape_token_file` is the --scrape-token-file path every daemon
    exposes — materialized here (generated on first start) so the flag
    behaves identically across daemons."""
    if port < 0:
        return None
    if scrape_token is None and scrape_token_file:
        from .tlsmaterial import ensure_token

        scrape_token = ensure_token(scrape_token_file)
    srv = MetricsServer(host=host, port=port, token=token,
                        scrape_token=scrape_token)
    srv.start()
    print(f"metrics: serving on {srv.url}", flush=True)
    return srv
