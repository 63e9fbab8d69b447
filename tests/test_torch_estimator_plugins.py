"""The port's estimator plugin framework and ResourceQuota plugin
(`karmada_tpu_torch.estimator.plugins`) held against the JAX package's on
the CPU: every case of tests/test_estimator.py's
`TestEstimatorPluginFramework` and `TestResourceQuotaReferenceFixtures`
gives the same replica count, result code and reasons in both packages
(the quotas built by the reference and carried across with
`from_reference_objects`); the result merge's precedence over every pair
of codes; the framework's min-merge into `AccurateEstimator`; and
`MemberEstimators` over members whose estimators carry a framework, which
takes the per-cluster host route (no fleet launch) and answers as the
reference's does.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api.meta import CPU, MEMORY, PODS  # noqa: E402
from karmada_tpu.api.work import ReplicaRequirements  # noqa: E402
from karmada_tpu.estimator import plugins as J  # noqa: E402
from karmada_tpu.features import RESOURCE_QUOTA_ESTIMATE  # noqa: E402
from karmada_tpu.features import FeatureGates as JGates  # noqa: E402

from karmada_tpu_torch import features as tfeatures  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.estimator import plugins as T  # noqa: E402

MiB = 1024.0 * 1024.0
GiB = 1024.0**3


def gates(pkg, on=True):
    g = JGates() if pkg is J else tfeatures.FeatureGates()
    g.set(RESOURCE_QUOTA_ESTIMATE, on)
    return g


def quota(scopes=None, selector=None, hard=None, used=None, name="rq", namespace="demo"):
    return J.ResourceQuota(name=name, namespace=namespace, scopes=scopes or [],
                           scope_selector=selector or [], hard=hard or {}, used=used or {})


def req(cpu=1.0, priority="", namespace="demo", **more):
    return ReplicaRequirements(resource_request={CPU: cpu, **more}, namespace=namespace,
                               priority_class_name=priority)


def foo_quota():
    return quota(name="foo", namespace="foo",
                 selector=[J.ScopedSelectorRequirement(
                     scope_name=J.SCOPE_PRIORITY_CLASS, operator=J.SCOPE_OP_IN,
                     values=["foo-priority"])],
                 hard={"cpu": 1.0, "memory": 4 * MiB, "nvidia.com/gpu": 5.0},
                 used={"cpu": 0.2, "memory": 1 * MiB, "nvidia.com/gpu": 2.0})


def bar_quota():
    return quota(name="bar", namespace="bar",
                 selector=[J.ScopedSelectorRequirement(
                     scope_name=J.SCOPE_PRIORITY_CLASS, operator=J.SCOPE_OP_IN,
                     values=["bar-priority"])],
                 hard={"limits.cpu": 1.0, "limits.memory": 4 * MiB,
                       "limits.nvidia.com/gpu": 5.0, "requests.cpu": 1.0,
                       "requests.memory": 4 * MiB, "requests.nvidia.com/gpu": 5.0},
                 used={"limits.cpu": 0.5, "limits.memory": 3 * MiB,
                       "limits.nvidia.com/gpu": 4.0, "requests.cpu": 0.2,
                       "requests.memory": 1 * MiB, "requests.nvidia.com/gpu": 2.0})


def _in_gold():
    return [J.ScopedSelectorRequirement(scope_name=J.SCOPE_PRIORITY_CLASS,
                                        operator=J.SCOPE_OP_IN, values=["gold"])]


def _all_scopes():
    return [J.SCOPE_TERMINATING, J.SCOPE_NOT_TERMINATING, J.SCOPE_BEST_EFFORT,
            J.SCOPE_NOT_BEST_EFFORT, J.SCOPE_CROSS_NS_AFFINITY]


def _req_all(cpu, ns, priority):
    return ReplicaRequirements(
        resource_request={"cpu": cpu, "memory": 2 * MiB, "nvidia.com/gpu": 1.0,
                          "ephemeral-storage": MiB},
        namespace=ns, priority_class_name=priority)


# name -> (quota, requirements, gate on): tests/test_estimator.py's cases
CASES = {
    "priority exists, no class": (
        quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"requests.cpu": 10.0},
              used={"requests.cpu": 4.0}), req(1.0), True),
    "priority exists, a class": (
        quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"requests.cpu": 10.0},
              used={"requests.cpu": 4.0}), req(1.0, "high"), True),
    "in selector, gold": (quota(selector=_in_gold(), hard={"cpu": 4.0}, used={"cpu": 0.0}),
                          req(2.0, "gold"), True),
    "in selector, silver": (quota(selector=_in_gold(), hard={"cpu": 4.0}, used={"cpu": 0.0}),
                            req(2.0, "silver"), True),
    "not-in and does-not-exist selectors": (
        quota(selector=[J.ScopedSelectorRequirement(scope_name=J.SCOPE_PRIORITY_CLASS,
                                                    operator=J.SCOPE_OP_NOT_IN,
                                                    values=["gold"]),
                        J.ScopedSelectorRequirement(scope_name=J.SCOPE_PRIORITY_CLASS,
                                                    operator=J.SCOPE_OP_DOES_NOT_EXIST)],
              hard={"cpu": 3.0}, used={"cpu": 1.0}), req(0.5, "silver"), True),
    "limits skipped, requests merged": (
        quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"limits.cpu": 1.0, "requests.cpu": 8.0},
              used={"limits.cpu": 1.0, "requests.cpu": 0.0}), req(1.0, "x"), True),
    "uncovered resource": (
        quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"requests.cpu": 2.0},
              used={"requests.cpu": 0.0}), req(1.0, "x", **{MEMORY: 64 * GiB}), True),
    "unscoped quota": (quota(hard={"cpu": 1.0}, used={"cpu": 0.0}), req(10.0, "x"), True),
    "gate off": (quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"cpu": 1.0}, used={"cpu": 0.0}),
                 req(10.0, "x"), False),
    "zero replicas": (quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"cpu": 1.0},
                            used={"cpu": 1.0}), req(1.0, "x"), True),
    "no requirements": (quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"cpu": 1.0},
                              used={"cpu": 0.0}), None, True),
    "foo cpu only": (foo_quota(), ReplicaRequirements(
        resource_request={"cpu": 0.2}, namespace="foo", priority_class_name="foo-priority"),
        True),
    "foo memory only": (foo_quota(), ReplicaRequirements(
        resource_request={"memory": 2 * MiB}, namespace="foo",
        priority_class_name="foo-priority"), True),
    "foo extended only": (foo_quota(), ReplicaRequirements(
        resource_request={"nvidia.com/gpu": 1.0}, namespace="foo",
        priority_class_name="foo-priority"), True),
    "foo ephemeral storage": (foo_quota(), ReplicaRequirements(
        resource_request={"ephemeral-storage": MiB}, namespace="foo",
        priority_class_name="foo-priority"), True),
    "foo all, unschedulable": (foo_quota(), _req_all(1.0, "foo", "foo-priority"), True),
    "foo all, min": (foo_quota(), _req_all(0.2, "foo", "foo-priority"), True),
    "bar requests bind": (bar_quota(), _req_all(0.2, "bar", "bar-priority"), True),
    "foo wrong class": (foo_quota(), ReplicaRequirements(
        resource_request={"cpu": 0.2}, namespace="foo", priority_class_name="other"), True),
    "other namespace": (foo_quota(), ReplicaRequirements(
        resource_request={"cpu": 0.2}, namespace="bar", priority_class_name="foo-priority"),
        True),
}


def _estimate(P, q, r, on):
    pl = P.ResourceQuotaEstimatorPlugin(
        lambda ns: [q] if ns == q.namespace else [], gates=gates(P, on))
    replicas, ret = pl.estimate(r)
    return replicas, ret.code, ret.name(), list(ret.reasons), ret.err, pl.enabled


@pytest.mark.parametrize("case", list(CASES))
def test_resource_quota_plugin_matches_reference(case):
    q, r, on = CASES[case]
    want = _estimate(J, q, r, on)
    assert _estimate(T, conv(q), conv(r), on) == want


def test_non_priority_scopes_never_match_like_the_reference():
    q = foo_quota()
    q.scope_selector = []
    q.scopes = _all_scopes()
    r = ReplicaRequirements(resource_request={"cpu": 0.2}, namespace="foo",
                            priority_class_name="foo-priority")
    want = _estimate(J, q, r, True)
    assert want[0] == J.MAX_INT32 and want[1] == J.NO_OPERATION
    assert _estimate(T, conv(q), conv(r), True) == want


def test_constants_match_reference():
    for name in ("MAX_INT32", "SUCCESS", "UNSCHEDULABLE", "NO_OPERATION", "ERROR",
                 "SCOPE_TERMINATING", "SCOPE_NOT_TERMINATING", "SCOPE_BEST_EFFORT",
                 "SCOPE_NOT_BEST_EFFORT", "SCOPE_PRIORITY_CLASS", "SCOPE_CROSS_NS_AFFINITY",
                 "SCOPE_OP_IN", "SCOPE_OP_NOT_IN", "SCOPE_OP_EXISTS", "SCOPE_OP_DOES_NOT_EXIST"):
        assert getattr(T, name) == getattr(J, name), name
    assert T.ResourceQuotaEstimatorPlugin.name == J.ResourceQuotaEstimatorPlugin.name
    assert T._CODE_NAMES == J._CODE_NAMES
    for rname in ("cpu", "requests.memory", "limits.cpu", "nvidia.com/gpu",
                  "requests.nvidia.com/gpu", "node.kubernetes.io/x", "ephemeral-storage",
                  "requests.storage", "pods"):
        assert T._matches_compute(rname) == J._matches_compute(rname), rname


def _result(P, code, i):
    return P.Result(code, reasons=[f"r{i}"], err="boom" if code == P.ERROR else None)


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_merge_results_matches_reference(n):
    """Every sequence of n result codes merges to the same code, reasons
    and error in both packages."""
    for codes in itertools.product(range(4), repeat=n):
        jr = J.merge_results({f"p{i}": _result(J, c, i) for i, c in enumerate(codes)})
        tr = T.merge_results({f"p{i}": _result(T, c, i) for i, c in enumerate(codes)})
        assert (tr.code, tr.reasons, tr.err, tr.is_success, tr.is_unschedulable, tr.is_noop) \
            == (jr.code, jr.reasons, jr.err, jr.is_success, jr.is_unschedulable, jr.is_noop)


class _Fixed:
    def __init__(self, P, name, replicas, code):
        self.name, self.replicas, self.code, self.P = name, replicas, code, P

    def estimate(self, requirements):
        return self.replicas, self.P.Result(self.code, reasons=[self.name])


@pytest.mark.parametrize("answers", [
    [(5, "SUCCESS"), (3, "SUCCESS")],
    [(5, "SUCCESS"), (1 << 40, "NO_OPERATION")],
    [(0, "UNSCHEDULABLE"), (7, "SUCCESS")],
    [(2, "ERROR"), (9, "SUCCESS")],
    [],
])
def test_framework_min_merge_matches_reference(answers):
    def run(P):
        fw = P.EstimatorFramework([_Fixed(P, f"p{i}", n, getattr(P, c))
                                   for i, (n, c) in enumerate(answers)])
        replicas, ret = fw.run_estimate_replicas_plugins(None)
        return replicas, ret.code, ret.reasons, ret.err

    assert run(T) == run(J)


def _nodes():
    from karmada_tpu.models.nodes import NodeSpec

    return [NodeSpec(name="n0", allocatable={CPU: 16.0, MEMORY: 64 * GiB, PODS: 110.0}),
            NodeSpec(name="n1", allocatable={CPU: 8.0, MEMORY: 32 * GiB, PODS: 110.0})]


def _framework(P, q):
    return P.EstimatorFramework([P.ResourceQuotaEstimatorPlugin(lambda ns: [q],
                                                                gates=gates(P))])


def test_framework_reaches_accurate_estimator_like_the_reference():
    from karmada_tpu.estimator.accurate import AccurateEstimator as JAccurate

    from karmada_tpu_torch.estimator.accurate import AccurateEstimator as TAccurate

    jq = quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"requests.cpu": 3.0},
               used={"requests.cpu": 0.0})
    tq = conv(jq)
    j = JAccurate(_nodes(), framework=_framework(J, jq))
    t = TAccurate(conv(_nodes()), framework=_framework(T, tq))
    reqs = [req(1.0, "gold"), req(1.0), req(0.5, "gold"), None]
    assert t.max_available_replicas_batch(conv(reqs)) == j.max_available_replicas_batch(reqs)
    assert t.max_available_replicas(conv(reqs[0])) == j.max_available_replicas(reqs[0]) == 3
    assert t.max_available_replicas(conv(reqs[1])) == j.max_available_replicas(reqs[1]) == 24
    jq.used = {"requests.cpu": 3.0}
    tq.used = {"requests.cpu": 3.0}
    assert t.max_available_replicas(conv(reqs[0])) == j.max_available_replicas(reqs[0]) == 0


class _Member:
    def __init__(self, est):
        self.node_estimator = est


def test_member_estimators_with_a_framework_take_the_host_route(monkeypatch):
    """Members whose estimators carry a framework: the sweep goes per
    cluster on the host (no fleet_estimate launch), with the quota's cap
    in every answer, equal to the reference's sweep."""
    from karmada_tpu.estimator.accurate import AccurateEstimator as JAccurate
    from karmada_tpu.estimator.client import MemberEstimators as JMembers

    from karmada_tpu_torch import kernels
    from karmada_tpu_torch.estimator.accurate import AccurateEstimator as TAccurate
    from karmada_tpu_torch.estimator.client import MemberEstimators as TMembers

    names = [f"m{i}" for i in range(6)]
    jm, tm = {}, {}
    for i, name in enumerate(names):
        jq = quota(scopes=[J.SCOPE_PRIORITY_CLASS], hard={"requests.cpu": 2.0 + i},
                   used={"requests.cpu": 0.5 * i})
        fw = (lambda P, q: _framework(P, q)) if i % 2 == 0 else (lambda P, q: None)
        jm[name] = _Member(JAccurate(_nodes(), framework=fw(J, jq)))
        tm[name] = _Member(TAccurate(conv(_nodes()), framework=fw(T, conv(jq))))
    calls = []
    fn = kernels.fleet_estimate
    monkeypatch.setattr(kernels, "fleet_estimate",
                        lambda *a, **kw: (calls.append(1), fn(*a, **kw))[1])
    reqs = [req(1.0, "gold"), req(0.25, "gold"), req(2.0), None]
    j, t = JMembers(jm), TMembers(tm, device="cpu")
    try:
        got = t.max_available_replicas_rows(names, conv(reqs))
        want = np.asarray(j.max_available_replicas_rows(names, reqs))
    finally:
        t.close()
    np.testing.assert_array_equal(got, want)
    assert not calls, "a member with a framework must not take the fleet launch"
    assert got[0, 0] == 2 and got[0, 2] == 3  # the quota's cap on framed members


def test_resource_quota_converts_field_for_field():
    q = bar_quota()
    t = conv(q)
    assert type(t) is T.ResourceQuota
    assert (t.name, t.namespace, t.scopes, t.hard, t.used) == \
        (q.name, q.namespace, q.scopes, q.hard, q.used)
    assert [type(s) for s in t.scope_selector] == [T.ScopedSelectorRequirement]
    assert [(s.scope_name, s.operator, s.values) for s in t.scope_selector] == \
        [(s.scope_name, s.operator, s.values) for s in q.scope_selector]
