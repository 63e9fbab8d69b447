"""FederatedResourceQuota admission preflight: simulate before you commit
(the port's copy of the JAX package's simulation/preflight.py).

A quota's staticAssignments cap what a namespace may consume per cluster.
The reference validates only the arithmetic (webhook/federatedresourcequota);
it cannot answer "will this cap strand replicas that are currently placed?".
This preflight can: it expresses the proposed caps as ONE Composite
capacity-delta scenario (each assigned cluster's available capacity clamped
down to the quota hard value), runs the namespace's bindings through the
simulation engine — the same solve the scheduler itself uses, no duplicated
logic — and denies the admission when the counterfactual re-solve leaves
previously-placeable replicas unplaceable or placed short.

`store` is any object with `list(kind, namespace=None)` (the port's Store
comes with the daemon slice); `device` is the simulator's (None means the
CUDA card). Mutates nothing: the simulator never touches the store, and a
denial surfaces as the standard AdmissionDenied 422.
"""
from __future__ import annotations

from ..api.simulation import SCENARIO_CAPACITY, SCENARIO_COMPOSITE, Scenario
from ..webhook.admission import DELETE, AdmissionDenied, AdmissionRequest

PREFLIGHT_WEBHOOK = "federatedresourcequota-preflight.karmada.io"


class QuotaPreflight:
    def __init__(self, store, device=None):
        self.store = store
        self.device = device

    def _caps_scenario(self, frq, clusters_by_name):
        steps = []
        for sa in frq.spec.static_assignments:
            c = clusters_by_name.get(sa.cluster_name)
            if c is None or c.status.resource_summary is None:
                continue
            rs = c.status.resource_summary
            deltas = {}
            for rname, hard in sa.hard.items():
                available = (
                    rs.allocatable.get(rname, 0.0)
                    - rs.allocated.get(rname, 0.0)
                    - rs.allocating.get(rname, 0.0)
                )
                if hard < available:
                    deltas[rname] = hard - available
            if deltas:
                steps.append(Scenario(
                    kind=SCENARIO_CAPACITY, cluster=sa.cluster_name,
                    resources=deltas,
                ))
        if not steps:
            return None
        return Scenario(
            kind=SCENARIO_COMPOSITE, steps=steps,
            name=f"quota-preflight({frq.metadata.name})",
        )

    def validate(self, req: AdmissionRequest) -> None:
        if req.operation == DELETE:
            return
        frq = req.obj
        if not frq.spec.static_assignments:
            return
        # status-only writes (the status controller's aggregation loop)
        # never re-run the solve
        old = req.old_obj
        if old is not None and old.spec == frq.spec:
            return
        ns = frq.metadata.namespace
        bindings = [
            rb for rb in self.store.list("ResourceBinding", ns)
            if rb.metadata.deletion_timestamp is None and rb.spec.replicas > 0
        ]
        if not bindings:
            return
        clusters = sorted(
            self.store.list("Cluster"), key=lambda c: c.metadata.name
        )
        if not clusters:
            return
        scenario = self._caps_scenario(
            frq, {c.metadata.name: c for c in clusters}
        )
        if scenario is None:
            return

        from .engine import Simulator
        from .report import fingerprint

        sim = Simulator(clusters, device=self.device)
        baseline, (capped,) = sim.simulate(bindings, [scenario])

        stranded: list[str] = []
        for rb in bindings:
            key = rb.metadata.key()
            if key in baseline.errors:
                continue  # already unplaceable without the quota
            if key in capped.errors:
                stranded.append(f"{key} ({capped.errors[key]})")
                continue
            before = sum(r for _, r in fingerprint(baseline.placements.get(key)))
            after = sum(r for _, r in fingerprint(capped.placements.get(key)))
            if after < before:
                stranded.append(
                    f"{key} (placed {after}/{before} replicas under the cap)"
                )
        if stranded:
            shown = "; ".join(stranded[:5])
            more = "" if len(stranded) <= 5 else f" (+{len(stranded) - 5} more)"
            raise AdmissionDenied(
                PREFLIGHT_WEBHOOK,
                f"{frq.metadata.name}: simulated re-solve under the proposed "
                f"caps strands replicas: {shown}{more}",
            )
