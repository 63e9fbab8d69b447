"""The port's host plane under the scheduler daemon held against the JAX
package's: the `Store` (rvs, generations, watch event sequences,
`ConflictError` / `BatchError` outcomes, `get_batch`, finalizer-gated
deletion, `Unstructured` kinds, the admission layer), the write coalescing
helpers (`update_all`'s skip-missing and skip-stale slots), and the
controller runtime (`Runtime.settle`, `BatchingController`'s singleton
isolation, `WorkQueue.on_add`). Each scenario runs once per package on the
same objects (explicit uids) and records a trace; the traces must be
equal."""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

PKGS = ("karmada_tpu", "karmada_tpu_torch")


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        store=imp("store.store"), batching=imp("store.batching"),
        controller=imp("runtime.controller"), meta=imp("api.meta"),
        work=imp("api.work"), unstructured=imp("api.unstructured"),
        admission=imp("webhook.admission"),
    )


def _rb(m, name: str, replicas: int, ns: str = "default"):
    return m.work.ResourceBinding(
        metadata=m.meta.ObjectMeta(namespace=ns, name=name, uid=f"uid-{name}"),
        spec=m.work.BindingSpec(
            resource=m.work.ObjectReference(
                api_version="apps/v1", kind="Deployment", namespace=ns, name=name),
            replicas=replicas,
        ),
    )


def _meta_view(obj):
    m = obj.metadata
    return (m.name, m.uid, m.resource_version, m.generation,
            m.deletion_timestamp is not None, tuple(m.finalizers))


def _batch_error_view(e):
    return [(r.ok, r.reason, r.retryable) for r in e.results]


def _crud_trace(m) -> list:
    s = m.store.Store()
    trace: list = []
    s.watch("ResourceBinding", lambda ev, rb: trace.append(
        ("watch", ev, rb.metadata.name, rb.metadata.resource_version,
         rb.metadata.generation, rb.spec.replicas)))
    trace.append(("create", _meta_view(s.create(_rb(m, "a", 2)))))
    trace.append(("create", _meta_view(s.create(_rb(m, "b", 3)))))
    try:
        s.create(_rb(m, "a", 9))
    except m.store.ConflictError as e:
        trace.append(("dup-create", type(e).__name__, str(e)))
    # a spec change bumps the generation, a status change does not
    a = s.get("ResourceBinding", "a", "default")
    a.spec.replicas = 4
    trace.append(("spec-update", _meta_view(s.update(a))))
    a = s.get("ResourceBinding", "a", "default")
    a.status.scheduler_observed_generation = a.metadata.generation
    trace.append(("status-update", _meta_view(s.update(a))))
    # a stale rv under check_rv conflicts, without it the write lands
    stale = s.get("ResourceBinding", "a", "default")
    stale.metadata.resource_version -= 1
    try:
        s.update(stale, check_rv=True)
    except m.store.ConflictError as e:
        trace.append(("stale-update", type(e).__name__, str(e)))
    try:
        s.update(_rb(m, "ghost", 1))
    except m.store.NotFoundError as e:
        trace.append(("missing-update", type(e).__name__, str(e)))
    # the transactional batch: all-or-nothing with per-object reasons
    a, b = s.get_batch("ResourceBinding", [("a", "default"), ("b", "default")])
    a.spec.replicas, b.spec.replicas = 5, 6
    trace.append(("batch", [_meta_view(o) for o in s.update_batch([a, b], check_rv=True)]))
    a.spec.replicas = 7  # a now carries a stale rv
    b2 = s.get("ResourceBinding", "b", "default")
    b2.spec.replicas = 8
    try:
        s.update_batch([b2, a], check_rv=True)
    except m.store.BatchError as e:
        trace.append(("batch-conflict", _batch_error_view(e)))
    try:
        s.update_batch([b2, _rb(m, "ghost", 1)])
    except m.store.BatchError as e:
        trace.append(("batch-missing", _batch_error_view(e)))
    out = s.update_batch([b2, _rb(m, "ghost", 1), a], skip_missing=True, skip_stale=True)
    trace.append(("batch-skip", [None if o is None else _meta_view(o) for o in out]))
    # update_all: the coalesced helper the daemon's patches ride
    a, b = s.get_batch("ResourceBinding", [("a", "default"), ("b", "default")])
    a.spec.replicas = 10
    b.metadata.resource_version -= 1
    out = m.batching.update_all(s, [a, _rb(m, "gone", 1), b], path="test",
                                skip_missing=True, skip_stale=True)
    trace.append(("update-all", [None if o is None else _meta_view(o) for o in out]))
    trace.append(("get-batch", [None if o is None else _meta_view(o) for o in s.get_batch(
        "ResourceBinding", [("a", "default"), ("zz", "default"), ("b", "default")])]))
    # finalizer-gated deletion: marked first, removed once the finalizer goes
    c = _rb(m, "c", 1)
    c.metadata.finalizers = ["hold"]
    s.create(c)
    s.delete("ResourceBinding", "c", "default")
    c = s.get("ResourceBinding", "c", "default")
    trace.append(("marked", _meta_view(c)))
    c.metadata.finalizers = []
    s.update(c)
    trace.append(("removed", s.try_get("ResourceBinding", "c", "default")))
    s.delete("ResourceBinding", "b", "default")
    trace.append(("list", [_meta_view(o) for o in s.list("ResourceBinding")]))
    # unstructured objects key by apiVersion/kind
    u = m.unstructured.Unstructured({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "default", "uid": "uid-web"},
        "spec": {"replicas": 2},
    })
    trace.append(("gvk", m.store.gvk_of(u), m.store.gvk_of(_rb(m, "x", 1))))
    got = s.create(u)
    trace.append(("unstructured", got.metadata.resource_version, got.metadata.generation,
                  sorted(s.kinds())))
    # a late watcher replays the current state, then sees new writes
    late: list = []
    s.watch("ResourceBinding", lambda ev, rb: late.append((ev, rb.metadata.name)))
    trace.append(("replay", late))
    return trace


def _admission_trace(m) -> list:
    s = m.store.Store()
    chain = m.admission.AdmissionChain()

    def mutate(req):
        req.obj.metadata.labels["admitted"] = req.operation.lower()
        return req.obj

    def validate(req):
        if req.obj.spec.replicas > 100:
            raise m.admission.AdmissionDenied("cap", "too many replicas")

    chain.register(m.admission.Webhook(
        name="cap", kinds=("ResourceBinding",), mutate=mutate, validate=validate))
    s.set_admission(chain.admit)
    trace: list = []
    trace.append(s.create(_rb(m, "a", 2)).metadata.labels)
    for obj in (_rb(m, "b", 200),):
        try:
            s.create(obj)
        except m.admission.AdmissionDenied as e:
            trace.append(("denied", str(e)))
    a = s.get("ResourceBinding", "a", "default")
    a.spec.replicas = 300
    try:
        s.update_batch([a])
    except m.store.BatchError as e:
        trace.append(("batch-denied", _batch_error_view(e)))
    a.spec.replicas = 5
    trace.append(("update", s.update(a).metadata.labels))
    trace.append([_meta_view(o) for o in s.list("ResourceBinding")])
    return trace


@pytest.mark.parametrize("scenario", [_crud_trace, _admission_trace],
                         ids=["crud_watch_batch", "admission"])
def test_store_matches_reference(scenario):
    ref, port = (scenario(_mods(p)) for p in PKGS)
    assert port == ref
    assert len(port) >= 5


def _runtime_trace(m) -> list:
    """Runtime.settle over a plain controller and a BatchingController:
    the batch raises whenever it holds the poison key, so the runtime
    isolates every key of a failed batch as a singleton and only the poison
    key burns its retry budget."""
    clock = m.controller.Clock(fixed=100.0)
    rt = m.controller.Runtime(clock=clock)
    trace: list = []

    def reconcile(key):
        trace.append(("one", key))
        return m.controller.DONE

    def reconcile_batch(keys):
        trace.append(("batch", tuple(keys)))
        if "poison" in keys:
            raise RuntimeError("poison")
        return []

    plain = rt.register(m.controller.Controller(name="plain", reconcile=reconcile))
    batched = rt.register(m.controller.BatchingController(
        name="batched", reconcile=None, reconcile_batch=reconcile_batch))
    batched.queue = m.controller.WorkQueue(max_retries=2)
    woken: list = []
    batched.queue.on_add = lambda: woken.append(len(batched.queue))
    for k in ("x", "y"):
        plain.enqueue(k)
    for k in ("a", "poison", "b", "a"):
        batched.enqueue(k)
    trace.append(("woken", woken))
    trace.append(("steps", rt.settle()))
    trace.append(("left", len(plain.queue), len(batched.queue)))
    return trace


def test_runtime_settle_and_singleton_isolation_match_reference():
    ref, port = (_runtime_trace(_mods(p)) for p in PKGS)
    assert port == ref
    batches = [t[1] for t in port if t[0] == "batch"]
    assert batches[0] == ("a", "poison", "b")
    # after the failed batch every key retries alone
    assert all(len(b) == 1 for b in batches[1:])


def test_workqueue_matches_reference():
    def trace(m):
        q = m.controller.WorkQueue(max_retries=1)
        out = []
        for k in ("k1", "k2", "k1", "k3"):
            q.add(k)
        out.append(("len", len(q)))
        out.append(("drain", q.drain(2)))
        q.readd("k1")
        out.append(("pop", q.pop(), q.pop(), q.pop()))
        out.append(("retry", q.retry("k9"), q.retry("k9"), len(q)))
        q.forget("k9")
        out.append(("after-forget", q.retry("k9")))
        return out

    ref, port = (trace(_mods(p)) for p in PKGS)
    assert port == ref
