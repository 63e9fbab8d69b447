"""Scheduler sidecar shim: the seam through which a stock Go
karmada-scheduler delegates its ScheduleAlgorithm.

A stock karmada-scheduler's ScheduleAlgorithm contract
(pkg/scheduler/core/generic_scheduler.go:36-38,70-115) is
`Schedule(spec, status, option) -> []TargetCluster`. This service exposes
that contract over HTTP with the reference's own JSON wire shapes
(api/k8sjson.py): a Go plugin delegates by POSTing `json.Marshal(spec)`
verbatim and patching the returned TargetCluster list — filter, score,
SelectClusters and AssignReplicas all run in the port's ArrayScheduler on
the card.

| method+path         | body                                   | returns |
|---------------------|----------------------------------------|---------|
| GET  /healthz       | —                                      | {ok}    |
| POST /v1/clusters   | {"items": [clusterv1alpha1 JSON, ...]} | {count} — replaces the fleet snapshot |
| POST /v1/schedule   | {"spec": RBSpec JSON, "status": {...}} | {"suggestedClusters": [TargetCluster...]} or {"error", "unschedulable"} |
| POST /v1/scheduleBatch | {"items": [{"spec":...}, ...]}      | {"results": [...]} — ONE batched round |

Unschedulable (capacity short / no feasible cluster) maps to HTTP 200 with
`unschedulable: true` — a scheduling outcome, not a transport error,
mirroring framework.FitError vs plain error (interface.go:71-93).

A copy of karmada_tpu/server/scheduler_shim.py; the shim takes the device
its ArrayScheduler runs on (None: the CUDA card, RuntimeError without
one) and records the host-clock span of its last round (`last_round`).
The caller passes an `ssl.SSLContext` for TLS.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .. import resolve_device
from ..api import k8sjson
from ..api.meta import ObjectMeta, new_uid
from ..api.work import BindingStatus, ResourceBinding
from .httpbase import (
    BackgroundHTTPServer,
    QuietHandler,
    bearer_auth_ok,
    drain_body,
    read_json,
    send_json,
)


def decision_json(d) -> dict:
    """One ScheduleDecision as the shim's result item."""
    if d.error:
        # FitError-style outcomes are unschedulable, not failures
        return {"error": d.error, "unschedulable": True}
    rec = {"suggestedClusters": k8sjson.target_clusters_to_json(d.targets)}
    if d.affinity_name:
        rec["appliedAffinityName"] = d.affinity_name
    return rec


class SchedulerShim:
    """The service core, callable in-process or via SchedulerShimServer."""

    def __init__(self, clusters: Optional[list] = None, estimator_registry=None,
                 device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._sched = None
        self._estimators = estimator_registry
        # (start, end) perf_counter seconds of the last round's
        # ArrayScheduler.schedule call
        self.last_round: Optional[tuple[float, float]] = None
        if clusters:
            self.sync_clusters_typed(clusters)

    # -- fleet snapshot ---------------------------------------------------

    def sync_clusters(self, cluster_jsons: list[dict]) -> int:
        return self.sync_clusters_typed(
            [k8sjson.cluster_from_json(d) for d in cluster_jsons]
        )

    def sync_clusters_typed(self, clusters: list) -> int:
        from ..sched.core import ArrayScheduler

        sched = ArrayScheduler(clusters, device=self.device)
        with self._lock:
            self._sched = sched
        return len(clusters)

    # -- the ScheduleAlgorithm contract ----------------------------------

    def schedule(self, spec_json: dict, status_json: Optional[dict] = None) -> dict:
        return self.schedule_batch([{"spec": spec_json, "status": status_json}])[0]

    def schedule_batch(self, items: list[dict]) -> list[dict]:
        """One batched solve for N bindings; per-item result dicts in order."""
        with self._lock:
            sched = self._sched
        if sched is None:
            return [
                {"error": "no cluster snapshot: POST /v1/clusters first",
                 "unschedulable": False}
                for _ in items
            ]
        bindings = []
        for i, item in enumerate(items):
            spec = k8sjson.binding_spec_from_json(item.get("spec") or {})
            status = BindingStatus(
                scheduler_observed_affinity_name=(
                    (item.get("status") or {}).get("schedulerObservedAffinityName", "")
                ),
            )
            name = spec.resource.name or f"item-{i}"
            bindings.append(ResourceBinding(
                metadata=ObjectMeta(
                    namespace=spec.resource.namespace, name=f"{name}-{i}",
                    # seed the deterministic tie-break (models/batch.py
                    # tie_matrix) from the template's own uid when the wire
                    # carries one: repeated calls for the same object then
                    # return identical placements
                    uid=spec.resource.uid or new_uid("shim"),
                ),
                spec=spec,
                status=status,
            ))
        extra = None
        if self._estimators is not None:
            # the registered estimators' min-merged i32[B,C] answers
            extra = self._estimators.batch_estimates(
                bindings, sched.fleet.names
            )
        t0 = time.perf_counter()
        decisions = sched.schedule(bindings, extra_avail=extra)
        self.last_round = (t0, time.perf_counter())
        return [decision_json(d) for d in decisions]


class SchedulerShimServer:
    """HTTP front-end over SchedulerShim. Loopback plaintext by default;
    pass `ssl_context` (an ssl.SSLContext) and `token` for cross-host
    deployments (GET /healthz stays unauthenticated). Without `shim` it
    serves a new SchedulerShim on `device` (None: the CUDA card)."""

    def __init__(self, shim: Optional[SchedulerShim] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None, token: Optional[str] = None, device=None):
        self.shim = shim or SchedulerShim(device=device)
        self._token = token
        self._server = BackgroundHTTPServer(host, port,
                                            ssl_context=ssl_context)

    def start(self) -> int:
        server = self

        class Handler(QuietHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    send_json(self, 200, {"ok": True})
                elif not bearer_auth_ok(self, server._token):
                    send_json(self, 401, {"error": "unauthorized"})
                else:
                    send_json(self, 404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    if not bearer_auth_ok(self, server._token):
                        drain_body(self)
                        send_json(self, 401, {"error": "unauthorized"})
                        return
                    body = read_json(self)
                    if self.path == "/v1/clusters":
                        n = server.shim.sync_clusters(body.get("items") or [])
                        send_json(self, 200, {"count": n})
                    elif self.path == "/v1/schedule":
                        send_json(self, 200, server.shim.schedule(
                            body.get("spec") or {}, body.get("status")
                        ))
                    elif self.path == "/v1/scheduleBatch":
                        send_json(self, 200, {
                            "results": server.shim.schedule_batch(
                                body.get("items") or []
                            ),
                        })
                    else:
                        send_json(self, 404, {"error": f"no route {self.path}"})
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 - wire boundary
                    send_json(self, 500, {"error": f"{type(e).__name__}: {e}"})

        return self._server.bind(Handler, "sched-shim")

    @property
    def url(self) -> str:
        return f"{self._server.scheme}://{self._server.host}:{self._server.port}"

    def stop(self) -> None:
        self._server.stop()
