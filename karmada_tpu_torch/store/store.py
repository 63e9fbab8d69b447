"""In-memory versioned object store with a watch bus.

The port's copy of the JAX package's `store/store.py`, unchanged in behaviour.

This is the control-plane storage/API layer (SURVEY L1 / D1): the reference
uses a stock kube-apiserver + etcd with level-triggered informers; we provide
the same contract — versioned objects, generation bumps on spec change, watch
events, finalizer-gated deletion — as an in-process store so every controller
can stay level-triggered and resumable (reference invariant: all state is CRDs,
device state is a rebuildable cache; SURVEY §5 checkpoint note).

Thread-safety and lock scope: a single RLock guards the maps, and the critical
section is kept to exactly the commit — validate, stamp, place, feed the
under-lock event sink. Input deepcopies happen before the lock, the
return/watcher copies and ALL watcher-bus dispatch happen after it drops
(including on the `apply` path, which used to notify re-entrantly under the
hold — the store side of the ABBA surface the queue side fixed first). Objects
are IMMUTABLE once committed: every mutation places a fresh copy, so readers
holding a committed reference (the watch cache retains them for lazy wire
encoding) never observe in-place changes.

Transactional batch writes (the etcd multi-op Txn analogue — PAPER.md L1:
write throughput comes from transactional commits, not raw fsync speed):
`create_batch` / `update_batch` / `apply_batch` admit, validate, and commit N
objects under ONE lock hold, minting contiguous resourceVersions and feeding
the event sink as one rv-ordered run; the batch then reaches persistence as a
single `watch_all_batch` delivery — one WAL group-commit unit, one fsync.
Semantics are all-or-nothing: any validation failure raises `BatchError` with
per-object typed results (conflict/not-found/admission/aborted) and commits
nothing, so a caller can distinguish re-send-the-rest from drop-this-one.
"""
from __future__ import annotations

import copy
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from ..analysis.lockorder import make_lock
from ..api.meta import ObjectMeta, new_uid, now
from ..api.unstructured import Unstructured
from ..metrics import store_lock_hold, store_lock_wait, txn_batch_size

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

WatchHandler = Callable[[str, Any], None]  # (event_type, obj)


class ConflictError(Exception):
    pass


class NotFoundError(KeyError):
    pass


class ReplicationGapError(ConflictError):
    """A replicated log entry does not start at the follower's next
    resourceVersion — the shipper must rewind to `expected_rv` (or fall
    back to a snapshot when the entry is already compacted out of its
    log)."""

    def __init__(self, message: str, expected_rv: int):
        super().__init__(message)
        self.expected_rv = expected_rv


@dataclass
class BatchOpResult:
    """Per-object disposition of a transactional batch write.

    reason: "" (committed) | "conflict" | "not-found" | "admission" |
    "skipped" (update_batch skip_missing) | "aborted" (this object was
    fine; a neighbor torched the batch)."""

    ok: bool
    obj: Any = None
    reason: str = ""
    error: str = ""

    @property
    def retryable(self) -> bool:
        """Worth re-sending as-is: the object conflicted with a racing
        writer or merely rode a batch a neighbor failed. Admission denials
        and not-found are terminal for this object."""
        return self.reason in ("conflict", "aborted")


class BatchError(Exception):
    """A transactional batch write failed validation: NOTHING was committed
    (all-or-nothing). `results` aligns 1:1 with the submitted objects — a
    conflict on one object leaves its neighbors marked `aborted` (retryable),
    so one bad object doesn't destroy the batch's retryable/terminal
    distinction."""

    def __init__(self, message: str, results: list[BatchOpResult]):
        super().__init__(message)
        self.results = results


def gvk_of(obj: Any) -> str:
    """Store key kind. Typed objects use their dataclass kind; unstructured
    use apiVersion+kind so e.g. apps/v1/Deployment is distinct."""
    if isinstance(obj, Unstructured):
        return f"{obj.api_version}/{obj.kind}"
    return obj.kind


@dataclass
class _Bucket:
    objects: dict[str, Any]
    watchers: list[tuple[WatchHandler, str]]  # (handler, namespace filter)


_REMOVED = object()  # batch-overlay tombstone (in-batch delete transition)


class Store:
    def __init__(self) -> None:
        # constructed through the lock-order seam: a plain RLock normally,
        # an instrumented one under KARMADA_TPU_LOCKCHECK=1 (the runtime
        # watchdog records the global acquisition-order graph and the
        # analysis tier-1 test fails on cycles — docs/ANALYSIS.md)
        self._lock = make_lock("store._lock", rlock=True)
        self._buckets: dict[str, _Bucket] = {}
        self._kinds_token = 0
        self._rv = 0
        self._all_watchers: list[Callable[[str, str, Any], None]] = []
        # event sinks run UNDER the mutation lock, at the point the rv is
        # assigned — unlike watchers (notified after the lock drops, so two
        # racing mutators may interleave), a sink observes the event log in
        # strict resourceVersion order. This is the feed for the revisioned
        # watch cache (store/watchcache.py); sinks must be fast, must never
        # call back into the store, and must never MUTATE the object — they
        # receive the committed (immutable-once-placed) object itself and
        # may retain the reference (the watch cache encodes it lazily,
        # outside this lock).
        self._event_sinks: list[Callable[[str, str, Any], None]] = []
        # batch watchers receive whole commit batches (single writes arrive
        # as one-element lists) OUTSIDE the lock — the persistence seam: a
        # transactional batch is delivered as ONE call so the WAL commits
        # it as one group-commit unit (one fsync)
        self._batch_watchers: list[
            Callable[[list[tuple[str, str, Any]]], None]
        ] = []
        # admission chain (op, kind, obj, old) -> obj; raises to deny —
        # the apiserver admission path (reference: pkg/webhook/* handlers)
        self._admission: Optional[Callable[[str, str, Any, Any], Any]] = None

    def set_admission(self, admit: Callable[[str, str, Any, Any], Any]) -> None:
        self._admission = admit

    def add_event_sink(self, sink: Callable[[str, str, Any], None], *,
                       prime: Optional[Callable[[str, Any], None]] = None) -> int:
        """Register an under-lock, rv-ordered event sink. The object passed
        is the committed stored object — immutable once placed — so a sink
        may retain the reference but must never mutate it (watchers get
        their own post-lock copy).

        `prime(kind, obj)` — when given — is called under the same lock hold
        for every object already stored, so a cache attaches with a snapshot
        index that is revision-consistent with the event feed (no mutation
        can land between the prime sweep and the first sinked event).
        Returns the store's current resourceVersion at attach time."""
        with self._lock:
            if prime is not None:
                for kind, b in self._buckets.items():
                    for o in b.objects.values():
                        prime(kind, copy.deepcopy(o))
            self._event_sinks.append(sink)
            return self._rv

    def remove_event_sink(self, sink: Callable[[str, str, Any], None]) -> None:
        with self._lock:
            if sink in self._event_sinks:
                self._event_sinks.remove(sink)

    def _sink(self, kind: str, event: str, obj: Any) -> None:
        """Feed event sinks; caller MUST hold self._lock."""
        for s in self._event_sinks:
            s(kind, event, obj)

    # -- helpers ----------------------------------------------------------

    def _bucket(self, kind: str) -> _Bucket:
        b = self._buckets.get(kind)
        if b is None:
            b = _Bucket(objects={}, watchers=[])
            self._buckets[kind] = b
            # kind registration bumps the token so kind-set caches (the
            # autoscaling template index) invalidate without re-listing
            self._kinds_token += 1
        return b

    @staticmethod
    def _key(meta: ObjectMeta) -> str:
        return meta.key()

    @staticmethod
    def _name_key(name: str, namespace: str) -> str:
        return ObjectMeta(name=name, namespace=namespace).key()

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    @contextmanager
    def _write_lock(self):
        """One measured hold of the store lock (the write paths). Lock-wait
        and lock-hold ride the karmada_store_lock_* histograms, observed
        AFTER release so the metrics mutex is never taken under the store
        lock. Re-entrant acquisitions (apply's inner commit) skip the
        metrics, so each write is measured exactly once."""
        lock = self._lock
        owned = getattr(lock, "_is_owned", None)
        if owned is not None and owned():
            with lock:
                yield
            return
        t0 = time.perf_counter()
        lock.acquire()
        t1 = time.perf_counter()
        try:
            yield
        finally:
            t2 = time.perf_counter()
            lock.release()
            store_lock_wait.observe(t1 - t0)
            store_lock_hold.observe(t2 - t1)

    def _peek_deletion_timestamp(self, kind: str, name: str, namespace: str):
        """Copy-free read of a stored object's deletionTimestamp (hot path:
        every update consults this for the removal-transition check)."""
        with self._lock:
            b = self._buckets.get(kind)
            if b is None:
                return None
            obj = b.objects.get(self._name_key(name, namespace))
            return None if obj is None else obj.metadata.deletion_timestamp

    @staticmethod
    def _spec_view(obj: Any) -> Any:
        """The part whose change bumps generation (k8s semantics: spec
        only). A comparison VIEW, not a copy — it is read for equality and
        dropped, and the old to_dict() round-trip deepcopied the whole
        manifest twice per update inside the lock hold."""
        if isinstance(obj, Unstructured):
            return obj.spec_view()
        spec = getattr(obj, "spec", None)
        return spec

    # -- admission wrappers (run OUTSIDE the lock on the direct paths) -----

    def _admit_create(self, obj: Any, kind: str) -> Any:
        if self._admission is not None:
            obj = self._admission("CREATE", kind, obj, None)
        return obj

    def _admit_update(self, obj: Any, kind: str) -> Any:
        if self._admission is not None:
            name, ns = obj.metadata.name, obj.metadata.namespace
            obj = self._admission("UPDATE", kind, obj, lambda: self.try_get(kind, name, ns))
            # an update that transitions into removal (deletionTimestamp set,
            # no finalizers left) IS a delete — run DELETE admission so
            # deletion protection cannot be bypassed via update()
            if not obj.metadata.finalizers and (
                obj.metadata.deletion_timestamp is not None
                or self._peek_deletion_timestamp(kind, name, ns) is not None
            ):
                self._admission("DELETE", kind, obj, None)
        return obj

    # -- commit primitives (caller holds the lock) -------------------------

    @staticmethod
    def _stamp_create(kind: str, stored: Any) -> None:
        m = stored.metadata
        if not m.uid:
            m.uid = new_uid(kind.split("/")[-1].lower())
        m.creation_timestamp = m.creation_timestamp or now()
        m.generation = 1

    @staticmethod
    def _stamp_update(stored: Any, existing: Any, check_rv: bool,
                      kind: str, key: str) -> tuple[str, bool]:
        """Stamp `stored` from its predecessor (uid, creation timestamp,
        generation bump on spec change, deletionTimestamp immutability);
        returns (event, removed) where removed means finalizer-gated
        removal. The caller mints the resourceVersion at commit."""
        if check_rv and stored.metadata.resource_version != existing.metadata.resource_version:
            raise ConflictError(
                f"{kind} {key}: rv {stored.metadata.resource_version} != "
                f"{existing.metadata.resource_version}"
            )
        m = stored.metadata
        m.uid = existing.metadata.uid
        m.creation_timestamp = existing.metadata.creation_timestamp
        m.generation = existing.metadata.generation
        # deletionTimestamp is immutable once set (k8s semantics): a stale
        # writer must not resurrect an object already marked for deletion.
        if existing.metadata.deletion_timestamp is not None:
            m.deletion_timestamp = existing.metadata.deletion_timestamp
        if Store._differs(Store._spec_view(existing), Store._spec_view(stored)):
            m.generation += 1
        if m.deletion_timestamp is not None and not m.finalizers:
            # removal gets a FRESH rv: a DELETED event must order after
            # every prior write of the object (WAL replay is rv-ordered)
            return DELETED, True
        return MODIFIED, False

    def _commit_create(self, kind: str, stored: Any) -> None:
        b = self._bucket(kind)
        key = self._key(stored.metadata)
        if key in b.objects:
            raise ConflictError(f"{kind} {key} already exists")
        self._stamp_create(kind, stored)
        stored.metadata.resource_version = self._next_rv()
        b.objects[key] = stored
        self._sink(kind, ADDED, stored)

    def _commit_update(self, kind: str, stored: Any, check_rv: bool) -> str:
        b = self._bucket(kind)
        key = self._key(stored.metadata)
        existing = b.objects.get(key)
        if existing is None:
            raise NotFoundError(f"{kind} {key}")
        event, removed = self._stamp_update(stored, existing, check_rv, kind, key)
        stored.metadata.resource_version = self._next_rv()
        if removed:
            del b.objects[key]
        else:
            b.objects[key] = stored
        self._sink(kind, event, stored)
        return event

    def _finish(self, kind: str, event: str, stored: Any) -> Any:
        """Post-commit tail, OUTSIDE the lock: the return/watcher copy and
        the persistence + watcher-bus dispatch. Subscribers may take their
        own locks — or call back into the store — without lock-order
        inversion, on every path including apply()."""
        out = copy.deepcopy(stored)
        self._dispatch([(kind, event, out)])
        return out

    # -- CRUD -------------------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = gvk_of(obj)
        obj = self._admit_create(obj, kind)
        stored = copy.deepcopy(obj)
        with self._write_lock():
            self._commit_create(kind, stored)
        return self._finish(kind, ADDED, stored)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        with self._lock:
            b = self._buckets.get(kind)
            key = self._name_key(name, namespace)
            if b is None or key not in b.objects:
                raise NotFoundError(f"{kind} {key}")
            obj = b.objects[key]
        # committed objects are immutable once placed: copy outside the lock
        return copy.deepcopy(obj)

    def try_get(self, kind: str, name: str, namespace: str = "") -> Optional[Any]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def get_batch(self, kind: str,
                  keys: Iterable[tuple[str, str]]) -> list[Optional[Any]]:
        """One lock hold for N point reads: [(name, namespace), ...] ->
        [obj | None]. The deepcopies happen outside the lock."""
        with self._lock:
            b = self._buckets.get(kind)
            refs = [
                None if b is None
                else b.objects.get(self._name_key(n, ns))
                for n, ns in keys
            ]
        return [None if o is None else copy.deepcopy(o) for o in refs]

    def list(self, kind: str, namespace: str = "") -> list[Any]:
        with self._lock:
            b = self._buckets.get(kind)
            if b is None:
                return []
            objs = list(b.objects.values())
        if namespace:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        return [copy.deepcopy(o) for o in objs]

    def kinds(self) -> list[str]:
        with self._lock:
            return list(self._buckets.keys())

    @property
    def kinds_token(self) -> int:
        """Monotonic counter bumped on every kind (bucket) registration.
        A cache keyed on kinds() content revalidates with one int compare
        instead of re-listing every kind per lookup."""
        with self._lock:
            return self._kinds_token

    def update(self, obj: Any, *, check_rv: bool = False) -> Any:
        """Update; bumps generation if the spec view changed. Finalizer-gated
        deletion: if deletionTimestamp set and no finalizers remain, the
        object is removed instead."""
        kind = gvk_of(obj)
        obj = self._admit_update(obj, kind)
        stored = copy.deepcopy(obj)
        with self._write_lock():
            event = self._commit_update(kind, stored, check_rv)
        return self._finish(kind, event, stored)

    def apply(self, obj: Any) -> Any:
        """create-or-update. The create-vs-update decision is made under
        the commit lock so concurrent apply() calls cannot race each other
        into ConflictError/NotFoundError — but the admission chain (user
        code: webhooks) and the input deepcopy run OUTSIDE the hold,
        against a one-peek existence guess, exactly like `_write_batch`'s
        apply path (lock-discipline rule: the critical section is
        validate+stamp+place+sink, nothing else). A racing writer that
        flips the guess re-runs the right chain under the lock — rare,
        never silently under-admitted. Watch handlers run AFTER the hold
        drops (they used to run re-entrantly under it on this path — the
        store half of the ABBA surface)."""
        kind = gvk_of(obj)
        key = self._key(obj.metadata)
        if self._admission is not None:
            with self._lock:
                guess_exists = key in self._bucket(kind).objects
            admitted = (self._admit_update(obj, kind) if guess_exists
                        else self._admit_create(obj, kind))
        else:
            guess_exists = None  # no chain: nothing depends on the guess
            admitted = obj
        stored = copy.deepcopy(admitted)
        with self._write_lock():
            exists = key in self._bucket(kind).objects
            if self._admission is not None and exists != guess_exists:
                # the existence race flipped create<->update after the
                # pre-lock admission: re-run the right chain here (under
                # the lock — baselined, like _write_batch's twin)
                admitted = (self._admit_update(obj, kind) if exists
                            else self._admit_create(obj, kind))
                stored = copy.deepcopy(admitted)
            if exists:
                event = self._commit_update(kind, stored, False)
            else:
                self._commit_create(kind, stored)
                event = ADDED
        return self._finish(kind, event, stored)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        """Marks deletionTimestamp; removes immediately when no finalizers."""
        if self._admission is not None:
            target = self.try_get(kind, name, namespace)
            if target is not None:
                self._admission("DELETE", kind, target, None)
        with self._write_lock():
            b = self._buckets.get(kind)
            key = self._name_key(name, namespace)
            if b is None or key not in b.objects:
                return
            # copy-on-write: committed objects are immutable once placed
            # (the watch cache retains references for lazy encoding) — the
            # marked copy REPLACES the stored object, never mutates it
            stored = copy.deepcopy(b.objects[key])
            m = stored.metadata
            if m.deletion_timestamp is None:
                m.deletion_timestamp = now()
            if m.finalizers:
                m.resource_version = self._next_rv()
                b.objects[key] = stored
                event = MODIFIED
            else:
                del b.objects[key]
                m.resource_version = self._next_rv()  # see _stamp_update
                event = DELETED
            self._sink(kind, event, stored)
        self._finish(kind, event, stored)

    @staticmethod
    def _differs(a: Any, b: Any) -> bool:
        if a is None and b is None:
            return False
        try:
            return a != b
        except Exception:
            return True

    # -- transactional batch writes ---------------------------------------

    def create_batch(self, objs: Iterable[Any]) -> list[Any]:
        """N creates admitted, validated, and committed under ONE lock hold
        with contiguous resourceVersions; the event sink sees one rv-ordered
        run and persistence one group-commit unit. All-or-nothing: any
        conflict/denial raises BatchError (typed per-object results) and
        commits nothing."""
        return self._write_batch([("create", o) for o in objs])

    def apply_batch(self, objs: Iterable[Any]) -> list[Any]:
        """Batched create-or-update; per-object semantics identical to N
        sequential apply() calls (same stamps, same events, contiguous rvs)
        at one lock hold and one WAL fsync."""
        return self._write_batch([("apply", o) for o in objs])

    def update_batch(self, objs: Iterable[Any], *, check_rv: bool = False,
                     skip_missing: bool = False,
                     skip_stale: bool = False) -> list[Optional[Any]]:
        """Batched update. `skip_missing=True` records a vanished object as
        a skipped slot (None in the result) instead of failing the batch —
        the patch-coalescing caller's tolerance for a delete racing its
        read-prepare-commit window. `skip_stale=True` (implies rv
        checking) does the same for an rv mismatch: a slot whose object
        was rewritten since the caller's read SKIPS instead of committing
        a stale full-object snapshot over the newer write — batching
        widens the read→commit window from per-object to per-cohort, and
        this is what keeps that window from ever clobbering a concurrent
        writer (the skipped slot's own change event re-converges the
        caller). NOTE for retry loops: with plain check_rv (no
        skip_stale), a replayed batch whose first attempt committed
        answers `conflict` for its own writes."""
        return self._write_batch(
            [("update", o) for o in objs],
            check_rv=check_rv or skip_stale, skip_missing=skip_missing,
            skip_stale=skip_stale,
        )

    @staticmethod
    def _abort_batch(results: list[BatchOpResult]) -> None:
        """All-or-nothing failure: objects that validated fine become
        `aborted` (retryable — they only rode a torched batch); raises."""
        for r in results:
            if r.ok:
                r.ok = False
                r.reason = "aborted"
                r.error = "batch aborted: nothing committed"
        bad = next((r for r in results if r.reason not in ("aborted", "skipped")),
                   None)
        raise BatchError(
            "batch write failed (nothing committed): "
            + (bad.error if bad is not None else "unknown"),
            results,
        )

    def _write_batch(self, ops: list[tuple[str, Any]], *,
                     check_rv: bool = False,
                     skip_missing: bool = False,
                     skip_stale: bool = False) -> list[Optional[Any]]:
        if not ops:
            return []
        from ..webhook.admission import AdmissionDenied  # optional layer

        n = len(ops)
        results = [BatchOpResult(ok=True) for _ in range(n)]
        failed = False

        # phase 1 — NO lock held across it: admission chains + input
        # deepcopies. The create-vs-update admission choice for "apply"
        # rides ONE existence-peek lock hold (skipped entirely without an
        # admission chain — phase 2 resolves the real op either way) and
        # is re-checked under the commit lock (a racing writer flipping it
        # re-runs the right chain there).
        guesses: dict[int, str] = {}
        if self._admission is not None and any(op == "apply" for op, _ in ops):
            with self._lock:
                for i, (op, obj) in enumerate(ops):
                    if op != "apply":
                        continue
                    b = self._buckets.get(gvk_of(obj))
                    guesses[i] = (
                        "update" if b is not None
                        and self._key(obj.metadata) in b.objects
                        else "create"
                    )
        prepped: list[Optional[tuple[str, str, str, Any, Any]]] = [None] * n
        for i, (op, obj) in enumerate(ops):
            kind = gvk_of(obj)
            eff = guesses.get(i, "create") if op == "apply" else op
            try:
                admitted = (self._admit_update(obj, kind) if eff == "update"
                            else self._admit_create(obj, kind))
            except AdmissionDenied as e:
                results[i] = BatchOpResult(False, reason="admission",
                                           error=str(e))
                failed = True
                continue
            prepped[i] = (op, eff, kind, copy.deepcopy(admitted), obj)
        if failed:
            self._abort_batch(results)

        # phase 2 — ONE lock hold: validate every op against an overlay of
        # the batch's own effects (in-batch create→update sequences behave
        # exactly like the sequential calls), then commit with contiguous
        # rvs, feeding the event sink in rv order. The buckets are not
        # touched until the whole batch validated.
        staged: list[Optional[tuple[str, str, Any, str, bool]]] = [None] * n
        events: list[tuple[int, str, str, Any]] = []
        with self._write_lock():
            overlay: dict[tuple[str, str], Any] = {}
            for i in range(n):
                op, eff_guess, kind, stored, raw = prepped[i]
                key = self._key(stored.metadata)
                okey = (kind, key)
                if okey in overlay:
                    existing = overlay[okey]
                    if existing is _REMOVED:
                        existing = None
                else:
                    b = self._buckets.get(kind)
                    existing = None if b is None else b.objects.get(key)
                eff = op
                if op == "apply":
                    eff = "update" if existing is not None else "create"
                    if eff != eff_guess and self._admission is not None:
                        # the existence race flipped create<->update after
                        # phase-1 admission: re-run the right chain (under
                        # the lock — rare, never silently under-admitted)
                        try:
                            admitted = (
                                self._admit_update(raw, kind) if eff == "update"
                                else self._admit_create(raw, kind)
                            )
                        except AdmissionDenied as e:
                            results[i] = BatchOpResult(
                                False, reason="admission", error=str(e))
                            failed = True
                            continue
                        stored = copy.deepcopy(admitted)
                if eff == "create":
                    if existing is not None:
                        results[i] = BatchOpResult(
                            False, reason="conflict",
                            error=f"{kind} {key} already exists")
                        failed = True
                        continue
                    self._stamp_create(kind, stored)
                    staged[i] = (kind, key, stored, ADDED, False)
                    overlay[okey] = stored
                else:
                    if existing is None:
                        if skip_missing:
                            results[i] = BatchOpResult(
                                False, reason="skipped",
                                error=f"{kind} {key} not found")
                            continue
                        results[i] = BatchOpResult(
                            False, reason="not-found",
                            error=f"{kind} {key}")
                        failed = True
                        continue
                    try:
                        event, removed = self._stamp_update(
                            stored, existing, check_rv, kind, key)
                    except ConflictError as e:
                        if skip_stale:
                            results[i] = BatchOpResult(
                                False, reason="skipped", error=str(e))
                            continue
                        results[i] = BatchOpResult(
                            False, reason="conflict", error=str(e))
                        failed = True
                        continue
                    staged[i] = (kind, key, stored, event, removed)
                    overlay[okey] = _REMOVED if removed else stored
            if failed:
                self._abort_batch(results)  # raises; lock releases
            for i in range(n):
                st = staged[i]
                if st is None:
                    continue
                kind, key, stored, event, removed = st
                stored.metadata.resource_version = self._next_rv()
                b = self._bucket(kind)
                if removed:
                    b.objects.pop(key, None)
                else:
                    b.objects[key] = stored
                self._sink(kind, event, stored)
                events.append((i, kind, event, stored))
        txn_batch_size.observe(float(len(events)))

        # phase 3 — outside the lock: watcher/return copies + dispatch (the
        # whole batch reaches persistence as ONE watch_all_batch call)
        outs: list[Optional[Any]] = [None] * n
        dispatch: list[tuple[str, str, Any]] = []
        for i, kind, event, stored in events:
            out = copy.deepcopy(stored)
            outs[i] = out
            results[i].obj = out
            dispatch.append((kind, event, out))
        self._dispatch(dispatch)
        return outs

    # -- replication (store/replication.py) --------------------------------

    @property
    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def apply_replicated(self, records: list[tuple[str, str, Any]]) -> int:
        """Follower-side commit of one leader log entry: `records` is a
        list of (kind, event, obj) whose resourceVersions were minted BY
        THE LEADER and must continue this store's sequence exactly
        (leader commits are globally contiguous, so a follower applying
        every entry in order holds the leader's byte-exact state at every
        applied rv — same watch-cache event stream, same snapshot pages).

        One lock hold for the whole entry, rv continuity validated BEFORE
        anything is applied (no partial entries), events fed to the
        under-lock sink with their ORIGINAL type and rv so the follower's
        revisioned watch cache is indistinguishable from the leader's.
        The post-lock dispatch reaches persistence as one batch — one WAL
        group-commit fsync per entry, mirroring the leader — so when this
        returns the entry is durable and the follower may ack it."""
        if not records:
            return self.current_rv
        with self._write_lock():
            base = self._rv
            for i, (kind, event, obj) in enumerate(records):
                rv = obj.metadata.resource_version
                if rv != base + 1 + i:
                    raise ReplicationGapError(
                        f"replication gap: record {i} of entry carries rv "
                        f"{rv}, follower expects {base + 1 + i}",
                        base + 1,
                    )
            for kind, event, obj in records:
                self._rv = obj.metadata.resource_version
                b = self._bucket(kind)
                key = self._key(obj.metadata)
                if event == DELETED:
                    b.objects.pop(key, None)
                else:
                    # decoded fresh off the wire: committed as-is, and the
                    # immutable-once-placed contract holds (a later entry
                    # REPLACES it, never mutates)
                    b.objects[key] = obj
                self._sink(kind, event, obj)
            tip = self._rv
        self._dispatch([
            (kind, event, copy.deepcopy(obj)) for kind, event, obj in records
        ])
        return tip

    def snapshot_state(self) -> tuple[int, list[tuple[str, Any]]]:
        """Revision-consistent full dump for replication catch-up: one
        lock hold pins (rv, [(kind, obj), ...]); the deepcopies happen
        outside it. The counterpart of load_snapshot() on the follower."""
        with self._lock:
            rv = self._rv
            refs = [
                (kind, o)
                for kind, b in self._buckets.items()
                for o in b.objects.values()
            ]
        return rv, [(kind, copy.deepcopy(o)) for kind, o in refs]

    def load_snapshot(self, rv: int, objects: Iterable[Any]) -> int:
        """Replication catch-up: replace the whole state with a leader
        snapshot pinned at `rv` and adopt that rv exactly, so subsequent
        log entries (rv+1, ...) continue the sequence. Only moves FORWARD
        (a follower needs a snapshot because it is behind). Event sinks
        may detach for the swap (the server detaches and re-attaches its
        watch cache around this call — re-attach primes a revision-
        consistent index); sinks that STAY attached receive the
        transition under the lock as DELETED-for-vanished + ADDED-for-all
        in rv order (how a follower's search ingest survives a catch-up
        snapshot), and the watcher bus and persistence get the same
        events post-lock, so a follower's WAL replays to the snapshot
        state."""
        objs = sorted(objects, key=lambda o: o.metadata.resource_version)
        dispatch: list[tuple[str, str, Any]] = []
        with self._write_lock():
            if rv < self._rv:
                raise ConflictError(
                    f"snapshot at rv {rv} is behind this store's rv "
                    f"{self._rv}"
                )
            old = {
                (kind, key): o
                for kind, b in self._buckets.items()
                for key, o in b.objects.items()
            }
            for b in self._buckets.values():
                # keep the buckets themselves: their watcher lists are
                # live subscriptions that must survive the state swap
                b.objects = {}
            seen: set[tuple[str, str]] = set()
            for obj in objs:
                kind = gvk_of(obj)
                key = self._key(obj.metadata)
                self._bucket(kind).objects[key] = obj
                seen.add((kind, key))
            self._rv = rv
            for (kind, key), o in old.items():
                if (kind, key) not in seen:
                    dispatch.append((kind, DELETED, o))
                    self._sink(kind, DELETED, o)
            for obj in objs:
                self._sink(gvk_of(obj), ADDED, obj)
        dispatch += [(gvk_of(o), ADDED, o) for o in objs]
        self._dispatch([
            (kind, event, copy.deepcopy(o)) for kind, event, o in dispatch
        ])
        return len(objs)

    # -- restore (persistence) --------------------------------------------

    def restore(self, objects: Iterable[Any]) -> int:
        """Load persisted objects verbatim — uid/resourceVersion/generation
        kept, admission NOT re-run (the reference's apiserver does not
        re-admit etcd content on restart). Watchers are notified ADDED so
        already-subscribed level-triggered controllers converge, exactly as
        an informer relist would deliver the initial state."""
        # input deepcopies BEFORE the lock (lock-discipline): restore runs
        # at boot, but a replication snapshot can land mid-flight and the
        # hold must stay validate+stamp+place+sink there too
        incoming = [(gvk_of(o), copy.deepcopy(o)) for o in objects]
        loaded: list[tuple[str, Any]] = []
        with self._lock:
            for kind, stored in incoming:
                b = self._bucket(kind)
                b.objects[self._key(stored.metadata)] = stored
                self._rv = max(self._rv, stored.metadata.resource_version)
                # restored rvs arrive in file order, not rv order — the
                # watch cache treats a non-monotonic rv as a compaction
                # point (no since-resume across a restore), so feeding them
                # here keeps its snapshot index complete without games
                self._sink(kind, ADDED, stored)
                loaded.append((kind, stored))
        self._dispatch([
            (kind, ADDED, copy.deepcopy(stored)) for kind, stored in loaded
        ])
        return len(loaded)

    # -- watch ------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler, *, replay: bool = True,
              namespace: str = "") -> None:
        """Subscribe; with replay=True existing objects are delivered as ADDED
        first (informer 'list+watch' semantics). A non-empty `namespace`
        scopes delivery — the reference agent's informers are scoped to its
        execution namespace the same way (agent.go:248-433)."""
        with self._lock:
            self._bucket(kind).watchers.append((handler, namespace))
            refs = [
                o for o in self._buckets[kind].objects.values()
                if not namespace or o.metadata.namespace == namespace
            ]
        # committed objects are immutable once placed: refs under the
        # lock, replay copies outside it (lock-discipline)
        if replay:
            for o in refs:
                handler(ADDED, copy.deepcopy(o))

    def unwatch(self, kind: str, handler: WatchHandler) -> None:
        """Drop a kind subscription (a disconnected watch stream must not
        keep filling a dead queue)."""
        with self._lock:
            b = self._buckets.get(kind)
            if b is not None:
                # equality, not identity: bound-method handlers compare ==
                # across separate attribute accesses but are never `is`
                b.watchers = [
                    (h, ns) for h, ns in b.watchers if h != handler
                ]

    def unwatch_all(self, handler: Callable[[str, str, Any], None]) -> None:
        with self._lock:
            if handler in self._all_watchers:
                self._all_watchers.remove(handler)

    def watch_all(self, handler: Callable[[str, str, Any], None], *, replay: bool = True) -> None:
        """Subscribe to every kind: handler(kind, event, obj). Used by the
        detector's dynamic-informer sweep (detector.go:112)."""
        with self._lock:
            self._all_watchers.append(handler)
            refs = [
                (kind, o)
                for kind, b in self._buckets.items()
                for o in b.objects.values()
            ]
        # immutable-once-placed: copy outside the hold (lock-discipline)
        if replay:
            for kind, o in refs:
                handler(kind, ADDED, copy.deepcopy(o))

    def watch_all_batch(
        self, handler: Callable[[list[tuple[str, str, Any]]], None]
    ) -> None:
        """Subscribe to commit batches: handler(events) with `events` a list
        of (kind, event, obj) in commit (resourceVersion) order. Single
        writes arrive as one-element batches; a transactional batch write
        arrives as ONE call — the seam the WAL's group commit turns into a
        single fsync. Runs outside the store lock, like the watcher bus."""
        with self._lock:
            self._batch_watchers.append(handler)

    def unwatch_all_batch(
        self, handler: Callable[[list[tuple[str, str, Any]]], None]
    ) -> None:
        with self._lock:
            if handler in self._batch_watchers:
                self._batch_watchers.remove(handler)

    def _dispatch(self, events: list[tuple[str, str, Any]]) -> None:
        """Deliver committed events to subscribers — always OUTSIDE the
        store lock. Batch watchers (persistence, replication) get the
        whole rv-ordered list first, so a mutator returns only after its
        records are durable; the kind/all watcher bus then fans out per
        event. Per-key ordering across RACING writers remains the sink's
        contract (under-lock sequencing), not the bus's.

        A batch watcher that RAISES (WAL write failure, replication
        quorum timeout) surfaces its error to the mutator — but the
        events are already committed to the store, so the per-event bus
        fan-out still runs first (finally): level-triggered subscribers
        must converge on committed state even when its durability or
        replication promise failed."""
        if not events:
            return
        with self._lock:
            batch_watchers = list(self._batch_watchers)
        try:
            for bw in batch_watchers:
                bw(events)
        finally:
            for kind, event, obj in events:
                self._notify(kind, event, obj)

    def _notify(self, kind: str, event: str, obj: Any) -> None:
        """Watcher-bus fan-out for one event; never called with the store
        lock held (see _dispatch)."""
        with self._lock:
            watchers = list(self._buckets[kind].watchers)
            all_watchers = list(self._all_watchers)
        ns = obj.metadata.namespace
        for w, want_ns in watchers:
            if not want_ns or ns == want_ns:
                w(event, obj)
        for w in all_watchers:
            w(kind, event, obj)
