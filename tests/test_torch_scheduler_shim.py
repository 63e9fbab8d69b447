"""The PyTorch port's scheduler sidecar shim held against the reference's
contract and the reference shim.

Every contract case of tests/test_scheduler_shim.py (the strategies, the
taint filter, unschedulable as an outcome, Steady scale-up, batch against
singular, the same object's same answer, the wire-parity fuzz, the HTTP
round trip in JSON and the binary codec, the token's 401) runs against
the port's shim on `device="cpu"` (karmada_tpu_torch/testing/
shim_contract.py; chip_smoke.py runs the same cases on the card). Then the
reference's graft example (24 clusters x 60 bindings) goes as JSON to the
reference shim and to the port's shim, whose result JSON must be
identical, and the port's k8sjson and binary codec must encode the
reference's objects and messages as the reference's do. The TLS case
builds its certificate with the reference's tlsmaterial."""
import json
import urllib.error

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as ge  # noqa: E402
from karmada_tpu.api import k8sjson as jk8sjson  # noqa: E402
from karmada_tpu.interpreter.interpreter import _parse_quantity as j_parse_quantity  # noqa: E402
from karmada_tpu.server import wirecodec as jwirecodec  # noqa: E402
from karmada_tpu.server.scheduler_shim import SchedulerShim as JSchedulerShim  # noqa: E402

from karmada_tpu_torch.api import k8sjson  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects  # noqa: E402
from karmada_tpu_torch.server import wirecodec  # noqa: E402
from karmada_tpu_torch.server.scheduler_shim import (  # noqa: E402
    SchedulerShim,
    SchedulerShimServer,
)
from karmada_tpu_torch.testing import shim_contract as sc  # noqa: E402


@pytest.mark.parametrize("case", sc.CONTRACT_CASES, ids=lambda c: c.__name__[5:])
def test_contract_case(case):
    case("cpu")


@pytest.fixture(scope="module")
def example_docs():
    """The reference graft example as reference JSON, each spec's template
    uid pinned to its binding's uid (the tie seed survives the wire)."""
    sched, _, bindings = ge._example_problem(n_clusters=24, n_bindings=60)
    for b in bindings:
        b.spec.resource.uid = b.metadata.uid
    clusters = sched.clusters[: sched.n_real_clusters]
    return (clusters, bindings, [jk8sjson.cluster_to_json(c) for c in clusters],
            [jk8sjson.binding_spec_to_json(b.spec) for b in bindings])


def test_fuzz_batch_same_json_as_reference_shim(example_docs):
    _, _, cluster_docs, spec_docs = example_docs
    items = [{"spec": d} for d in spec_docs]
    ref = JSchedulerShim()
    port = SchedulerShim(device="cpu")
    assert ref.sync_clusters(cluster_docs) == port.sync_clusters(cluster_docs) == 24
    want = ref.schedule_batch(items)
    got = port.schedule_batch(items)
    assert json.dumps(got) == json.dumps(want)
    assert sum(len(r.get("suggestedClusters", [])) for r in want) > 60


def test_fuzz_batch_over_http_same_json(example_docs):
    """The same batch over the port's HTTP server (binary body) equals the
    reference shim in-process."""
    _, _, cluster_docs, spec_docs = example_docs
    items = [{"spec": d} for d in spec_docs]
    ref = JSchedulerShim()
    ref.sync_clusters(cluster_docs)
    srv = SchedulerShimServer(device="cpu")
    srv.start()
    try:
        assert sc.post_json(f"{srv.url}/v1/clusters", {"items": cluster_docs}) == {"count": 24}
        got = sc.post_json(f"{srv.url}/v1/scheduleBatch", {"items": items}, binary=True)
    finally:
        srv.stop()
    assert got == {"results": ref.schedule_batch(items)}
    t0, t1 = srv.shim.last_round
    assert t1 >= t0


def test_k8sjson_encodes_reference_objects_alike(example_docs):
    """The port's to_json of the reference's objects carried across equals
    the reference's JSON; its from_json of that JSON round-trips."""
    clusters, bindings, cluster_docs, spec_docs = example_docs
    for c, doc in zip(from_reference_objects(clusters), cluster_docs):
        assert k8sjson.cluster_to_json(c) == doc
        assert k8sjson.cluster_to_json(k8sjson.cluster_from_json(doc)) == doc
    for b, doc in zip(from_reference_objects(bindings), spec_docs):
        assert k8sjson.binding_spec_to_json(b.spec) == doc
        assert k8sjson.binding_spec_to_json(k8sjson.binding_spec_from_json(doc)) == doc


def test_fixpoint_edge_shapes():
    """Shapes where marshal and parse disagree on defaults: empty
    selector, empty toleration operator, minGroups 0."""
    from karmada_tpu_torch.api import policy as pol
    from karmada_tpu_torch.api.meta import LabelSelector

    p = pol.Placement(
        cluster_affinity=pol.ClusterAffinity(label_selector=LabelSelector()),
        cluster_tolerations=[pol.Toleration(key="k", operator="")],
        spread_constraints=[
            pol.SpreadConstraint(spread_by_field=pol.SPREAD_BY_FIELD_CLUSTER, min_groups=0)
        ],
    )
    doc = k8sjson.placement_to_json(p)
    assert k8sjson.placement_to_json(k8sjson.placement_from_json(doc)) == doc
    assert doc["clusterTolerations"][0]["operator"] == "Equal"
    assert doc["spreadConstraints"][0]["minGroups"] == 1
    assert "labelSelector" not in doc["clusterAffinity"]


@pytest.mark.parametrize("q", ["100m", "2", "1.5", "4Gi", "512Mi", "3k", "1e3", 7, 0.25,
                               "2T", "1Pi"])
def test_parse_quantity_as_reference(q):
    assert k8sjson._parse_quantity(q) == j_parse_quantity(q)


def test_parse_quantity_rejects_as_reference():
    for bad in ("abc", "1Xi"):
        with pytest.raises(ValueError):
            j_parse_quantity(bad)
        with pytest.raises(ValueError):
            k8sjson._parse_quantity(bad)


def test_message_codec_as_reference():
    """pack_message gives the reference's bytes, and each side reads the
    other's; framing violations raise."""
    msg = {"items": [{"spec": sc.spec_json("a", replicas=3)}], "n": [1, 2.5, None]}
    packed = wirecodec.pack_message(msg)
    assert packed == jwirecodec.pack_message(msg)
    assert wirecodec.unpack_message(jwirecodec.pack_message(msg)) == msg
    for bad in (packed[:5], b"XX" + packed[2:], packed + b"!",
                wirecodec.pack_frame(1, b"{}")):
        with pytest.raises(wirecodec.WireProtocolError):
            wirecodec.unpack_message(bad)
    assert wirecodec.is_binary_content_type(wirecodec.CONTENT_TYPE_BIN + "; v=1")
    assert not wirecodec.is_binary_content_type("application/json")
    assert (wirecodec.CONTENT_TYPE_BIN, wirecodec.HEADER_WIRE) == (
        jwirecodec.CONTENT_TYPE_BIN, jwirecodec.HEADER_WIRE)


def test_tls_and_token(tmp_path):
    """HTTPS from cluster-CA material (the caller's ssl.SSLContext) and
    bearer auth; /healthz is open; a 401 with an unread body leaves the
    keep-alive connection usable."""
    import http.client
    import ssl

    from karmada_tpu.server.tlsmaterial import ensure_server_tls, ensure_token

    ctx = ensure_server_tls(str(tmp_path / "tls"), "127.0.0.1")
    token = ensure_token(str(tmp_path / "token"))
    srv = SchedulerShimServer(ssl_context=ctx, token=token, device="cpu")
    port = srv.start()
    assert srv.url.startswith("https://")
    client_ctx = ssl.create_default_context(cafile=str(tmp_path / "tls" / "ca.pem"))
    try:
        out = sc.post_json(f"{srv.url}/v1/clusters", {"items": [sc.cluster_json("m1")]},
                           token=token, context=client_ctx)
        assert out == {"count": 1}
        with pytest.raises(urllib.error.HTTPError) as e:
            sc.post_json(f"{srv.url}/v1/clusters", {"items": []}, token="wrong",
                         context=client_ctx)
        assert e.value.code == 401
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30, context=client_ctx)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert json.loads(resp.read().decode()) == {"ok": True}
            body = json.dumps({"items": [sc.cluster_json("m2")]})
            for tok, status in (("wrong", 401), (token, 200)):
                conn.request("POST", "/v1/clusters", body=body, headers={
                    "Content-Type": "application/json", "Authorization": f"Bearer {tok}"})
                resp = conn.getresponse()
                assert resp.status == status
                reply = json.loads(resp.read().decode())
            assert reply == {"count": 1}
        finally:
            conn.close()
    finally:
        srv.stop()


def test_unknown_route_and_bad_body():
    """404 for an unknown route; a body that is not JSON is a 500 at the
    wire boundary, as in the reference."""
    import http.client

    srv = SchedulerShimServer(device="cpu")
    port = srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        for path, body, status in (("/v1/nope", "{}", 404), ("/v1/schedule", "{not json", 500)):
            conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == status
            assert "error" in json.loads(resp.read().decode())
        conn.request("GET", "/v1/clusters")
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
    finally:
        conn.close()
        srv.stop()


def test_estimator_registry_answers_tighten_the_round():
    """A registry's answers reach the round as extra_avail: a 0 answer on
    m2 leaves a dynamic row to m1 and m3."""
    class Registry:
        def batch_estimates(self, bindings, names):
            out = np.full((len(bindings), len(names)), -1, np.int32)
            out[:, names.index("m2")] = 0
            return out

    shim = SchedulerShim(estimator_registry=Registry(), device="cpu")
    shim.sync_clusters([sc.cluster_json("m1", cpu="10"), sc.cluster_json("m2", cpu="30"),
                        sc.cluster_json("m3", cpu="20")])
    got = sc.targets_of(shim.schedule(sc.spec_json(replicas=6, cpu_request="1",
                                                   placement=sc.DYNAMIC_ALL)))
    assert "m2" not in got and sum(got.values()) == 6


def test_shim_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedulerShim()
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedulerShimServer()
