"""The scheduler shim's contract cases, runnable on any device.

Inputs are reference-shaped JSON: what `json.Marshal` of Go
workv1alpha2.ResourceBindingSpec / clusterv1alpha1.Cluster produces
(binding_types.go / cluster types.go JSON tags). Expected placements are
the Go path's answers per pkg/scheduler/core/{assignment,
division_algorithm}.go and util/helper/binding.go's Dispenser — the shim
must be a drop-in ScheduleAlgorithm (generic_scheduler.go:36-38). The
cases are those of the reference's shim contract tests; each
`case_*(device)` raises AssertionError on a wrong answer.
`tests/test_torch_scheduler_shim.py` runs them on the CPU and
`chip_smoke.py` on the card.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request

from ..api import k8sjson
from ..server.scheduler_shim import SchedulerShim, SchedulerShimServer


def cluster_json(name, cpu="100", region="r1", taints=None, allocated="0"):
    return {
        "apiVersion": "cluster.karmada.io/v1alpha1",
        "kind": "Cluster",
        "metadata": {"name": name, "labels": {"fleet": "test"}},
        "spec": {
            "syncMode": "Push",
            "region": region,
            **({"taints": taints} if taints else {}),
        },
        "status": {
            "kubernetesVersion": "v1.30.0",
            "apiEnablements": [
                {"groupVersion": "apps/v1",
                 "resources": [{"name": "deployments", "kind": "Deployment"}]},
            ],
            "conditions": [
                {"type": "Ready", "status": "True", "reason": "ClusterReady"},
            ],
            "resourceSummary": {
                "allocatable": {"cpu": cpu, "memory": "400Gi", "pods": "1000"},
                "allocated": {"cpu": allocated},
            },
        },
    }


def spec_json(name="app", replicas=0, placement=None, cpu_request="100m",
              clusters=None, reschedule=None):
    d = {
        "resource": {"apiVersion": "apps/v1", "kind": "Deployment",
                     "namespace": "default", "name": name},
        "replicas": replicas,
        "replicaRequirements": {
            "resourceRequest": {"cpu": cpu_request},
        },
        "placement": placement or {},
    }
    if clusters:
        d["clusters"] = clusters
    if reschedule:
        d["rescheduleTriggeredAt"] = reschedule
    return d


def targets_of(result):
    assert "error" not in result, result
    return {tc["name"]: tc.get("replicas", 0)
            for tc in result["suggestedClusters"]}


def contract_shim(device) -> SchedulerShim:
    """m1 (10 cpu, r1), m2 (30 cpu, r2), m3 (20 cpu, r2)."""
    s = SchedulerShim(device=device)
    s.sync_clusters([
        cluster_json("m1", cpu="10"),
        cluster_json("m2", cpu="30", region="r2"),
        cluster_json("m3", cpu="20", region="r2"),
    ])
    return s


STATIC_1_2 = {
    "clusterAffinity": {"clusterNames": ["m1", "m2"]},
    "replicaScheduling": {
        "replicaSchedulingType": "Divided",
        "replicaDivisionPreference": "Weighted",
        "weightPreference": {"staticWeightList": [
            {"targetCluster": {"clusterNames": ["m1"]}, "weight": 1},
            {"targetCluster": {"clusterNames": ["m2"]}, "weight": 2},
        ]},
    },
}
DYNAMIC_ALL = {
    "clusterAffinity": {"clusterNames": ["m1", "m2", "m3"]},
    "replicaScheduling": {
        "replicaSchedulingType": "Divided",
        "replicaDivisionPreference": "Weighted",
        "weightPreference": {"dynamicWeight": "AvailableReplicas"},
    },
}


def case_duplicated_full_replicas_everywhere(device):
    # assignByDuplicatedStrategy (assignment.go:176-182)
    result = contract_shim(device).schedule(spec_json(replicas=4, placement={
        "clusterAffinity": {"clusterNames": ["m1", "m2", "m3"]},
        "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
    }))
    assert targets_of(result) == {"m1": 4, "m2": 4, "m3": 4}


def case_static_weight_largest_remainder(device):
    # TakeByWeight (util/helper/binding.go:112-144): 9 by 1:2 -> 3/6
    result = contract_shim(device).schedule(spec_json(replicas=9, placement=STATIC_1_2))
    assert targets_of(result) == {"m1": 3, "m2": 6}


def case_dynamic_weight_by_available_replicas(device):
    # dynamicDivideReplicas (division_algorithm.go:75-99): free cpu
    # m1=10 m2=30 m3=20 at 1 cpu/replica -> weights 10:30:20; 6 -> 1/3/2
    result = contract_shim(device).schedule(
        spec_json(replicas=6, cpu_request="1", placement=DYNAMIC_ALL))
    assert targets_of(result) == {"m1": 1, "m2": 3, "m3": 2}


def case_aggregated_packs_fewest_clusters(device):
    # division_algorithm.go:80-90: sort by available desc, truncate to the
    # covering prefix: m2(30) alone covers 8
    result = contract_shim(device).schedule(spec_json(replicas=8, cpu_request="1", placement={
        "clusterAffinity": {"clusterNames": ["m1", "m2", "m3"]},
        "replicaScheduling": {
            "replicaSchedulingType": "Divided",
            "replicaDivisionPreference": "Aggregated",
        },
    }))
    assert targets_of(result) == {"m2": 8}


def case_taint_filters_untolerated_cluster(device):
    shim = SchedulerShim(device=device)
    shim.sync_clusters([
        cluster_json("ok", cpu="10"),
        cluster_json("tainted", cpu="10", taints=[
            {"key": "maintenance", "value": "true", "effect": "NoSchedule"},
        ]),
    ])
    result = shim.schedule(spec_json(replicas=2, placement={
        "clusterAffinity": {"clusterNames": ["ok", "tainted"]},
        "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
    }))
    assert set(targets_of(result)) == {"ok"}
    # with a matching toleration the taint no longer filters
    result = shim.schedule(spec_json(replicas=2, placement={
        "clusterAffinity": {"clusterNames": ["ok", "tainted"]},
        "clusterTolerations": [
            {"key": "maintenance", "operator": "Equal", "value": "true",
             "effect": "NoSchedule"},
        ],
        "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
    }))
    assert set(targets_of(result)) == {"ok", "tainted"}


def case_unschedulable_is_an_outcome_not_an_error(device):
    # capacity 60 total at 1 cpu; 1000 replicas cannot fit ->
    # framework.FitError equivalent
    result = contract_shim(device).schedule(
        spec_json(replicas=1000, cpu_request="1", placement=DYNAMIC_ALL))
    assert result.get("unschedulable") is True
    assert result.get("error")


def case_steady_scale_up_keeps_prior_clusters_first(device):
    # assignment.go:120-173 resortAvailableClusters: previous clusters
    # retain their replicas; only the delta disperses
    result = contract_shim(device).schedule(spec_json(
        replicas=12, cpu_request="1",
        clusters=[{"name": "m3", "replicas": 10}],
        placement={
            "clusterAffinity": {"clusterNames": ["m1", "m2", "m3"]},
            "replicaScheduling": {
                "replicaSchedulingType": "Divided",
                "replicaDivisionPreference": "Aggregated",
            },
        }))
    got = targets_of(result)
    assert got.get("m3", 0) >= 10  # stickiness held
    assert sum(got.values()) == 12


def case_batch_matches_singular(device):
    shim = contract_shim(device)
    specs = [
        spec_json("a", replicas=4, placement={
            "clusterAffinity": {"clusterNames": ["m1", "m2", "m3"]},
            "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
        }),
        spec_json("b", replicas=9, placement=STATIC_1_2),
    ]
    batch = shim.schedule_batch([{"spec": s} for s in specs])
    singular = [shim.schedule(s) for s in specs]
    assert [targets_of(r) for r in batch] == [targets_of(r) for r in singular]


def case_same_object_same_answer(device):
    """uid-seeded tie-break: repeated shim calls for one template are
    idempotent even where the division has exact ties."""
    shim = SchedulerShim(device=device)
    shim.sync_clusters([cluster_json("m1", cpu="10"), cluster_json("m2", cpu="10")])
    spec = spec_json(replicas=3, cpu_request="1", placement={
        "clusterAffinity": {"clusterNames": ["m1", "m2"]},
        "replicaScheduling": {
            "replicaSchedulingType": "Divided",
            "replicaDivisionPreference": "Weighted",
            "weightPreference": {"staticWeightList": [
                {"targetCluster": {"clusterNames": ["m1"]}, "weight": 1},
                {"targetCluster": {"clusterNames": ["m2"]}, "weight": 1},
            ]},
        },
    })
    spec["resource"]["uid"] = "rb-fixed-uid"
    first = targets_of(shim.schedule(spec))
    for _ in range(3):
        assert targets_of(shim.schedule(spec)) == first


def case_wire_parity_fuzz(device):
    """Typed objects -> reference JSON -> shim place as the in-process
    ArrayScheduler does on the same objects (every strategy family in one
    batch), and marshal/parse is a JSON fixpoint."""
    from ..graft_entry import example_objects
    from ..sched.core import ArrayScheduler

    clusters, bindings = example_objects(24, 60)
    # pin each binding's identity to its template uid so the uid-seeded
    # tie survives the wire (the shim rebuilds metadata from the spec)
    for b in bindings:
        b.spec.resource.uid = b.metadata.uid
    want = ArrayScheduler(clusters, device=device).schedule(bindings)
    cluster_docs = [k8sjson.cluster_to_json(c) for c in clusters]
    for doc in cluster_docs:
        assert k8sjson.cluster_to_json(k8sjson.cluster_from_json(doc)) == doc
    spec_docs = [k8sjson.binding_spec_to_json(b.spec) for b in bindings]
    for doc in spec_docs:
        assert k8sjson.binding_spec_to_json(k8sjson.binding_spec_from_json(doc)) == doc
    shim = SchedulerShim(device=device)
    assert shim.sync_clusters(cluster_docs) == len(cluster_docs)
    got = shim.schedule_batch([{"spec": d} for d in spec_docs])
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        if w.error:
            assert g.get("unschedulable"), (i, w.error, g)
            continue
        assert {t.name: t.replicas for t in w.targets} == {
            tc["name"]: tc.get("replicas", 0) for tc in g["suggestedClusters"]
        }, f"row {i} diverged over the wire"


def post_json(url, body, token=None, context=None, binary=False):
    """POST `body` (JSON, or the binary message codec) and return the
    decoded reply."""
    from ..server import wirecodec

    data = wirecodec.pack_message(body) if binary else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": wirecodec.CONTENT_TYPE_BIN if binary else "application/json",
        **({"Authorization": f"Bearer {token}"} if token else {}),
    })
    with urllib.request.urlopen(req, timeout=60, context=context) as r:
        return json.loads(r.read().decode())


def case_wire_roundtrip(device):
    """The three POST routes over HTTP, JSON and binary bodies; a schedule
    before any snapshot is a typed error, not a 500."""
    srv = SchedulerShimServer(device=device)
    srv.start()
    try:
        out = post_json(f"{srv.url}/v1/clusters", {"items": [
            cluster_json("m1", cpu="10"), cluster_json("m2", cpu="30"),
        ]})
        assert out == {"count": 2}
        dup = {
            "clusterAffinity": {"clusterNames": ["m1", "m2"]},
            "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
        }
        for binary in (False, True):
            out = post_json(f"{srv.url}/v1/schedule",
                            {"spec": spec_json(replicas=3, placement=dup)}, binary=binary)
            assert {tc["name"]: tc["replicas"]
                    for tc in out["suggestedClusters"]} == {"m1": 3, "m2": 3}
        out = post_json(f"{srv.url}/v1/scheduleBatch", {"items": [
            {"spec": spec_json("x", replicas=2, placement={
                "clusterAffinity": {"clusterNames": ["m1"]},
                "replicaScheduling": {"replicaSchedulingType": "Duplicated"},
            })},
        ]})
        assert out["results"][0]["suggestedClusters"] == [{"name": "m1", "replicas": 2}]
        srv2 = SchedulerShimServer(device=device)
        srv2.start()
        try:
            out = post_json(f"{srv2.url}/v1/schedule", {"spec": spec_json()})
            assert "no cluster snapshot" in out["error"]
        finally:
            srv2.stop()
    finally:
        srv.stop()


def case_token_unauthorized(device):
    """A wrong bearer token is a 401 (the body drained, so the connection
    stays usable); /healthz needs none."""
    import http.client

    srv = SchedulerShimServer(device=device, token="s3cret")
    port = srv.start()
    try:
        try:
            post_json(f"{srv.url}/v1/clusters", {"items": []}, token="wrong")
            raise AssertionError("a wrong token was accepted")
        except urllib.error.HTTPError as e:
            assert e.code == 401, e.code
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=30) as r:
            assert json.loads(r.read().decode()) == {"ok": True}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            body = json.dumps({"items": [cluster_json("m2")]})
            for tok, status in (("wrong", 401), ("s3cret", 200)):
                conn.request("POST", "/v1/clusters", body=body, headers={
                    "Content-Type": "application/json", "Authorization": f"Bearer {tok}",
                })
                resp = conn.getresponse()
                assert resp.status == status, (tok, resp.status)
                reply = json.loads(resp.read().decode())
            assert reply == {"count": 1}
        finally:
            conn.close()
    finally:
        srv.stop()


CONTRACT_CASES = (
    case_duplicated_full_replicas_everywhere,
    case_static_weight_largest_remainder,
    case_dynamic_weight_by_available_replicas,
    case_aggregated_packs_fewest_clusters,
    case_taint_filters_untolerated_cluster,
    case_unschedulable_is_an_outcome_not_an_error,
    case_steady_scale_up_keeps_prior_clusters_first,
    case_batch_matches_singular,
    case_same_object_same_answer,
    case_wire_parity_fuzz,
    case_wire_roundtrip,
    case_token_unauthorized,
)
