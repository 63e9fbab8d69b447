"""Cross-shard gang commit: the local gang's all-or-nothing semantics across
shards (the port's copy of the reference's sched/shards/gangs.py; its
commits, vetoes and outcomes are the reference's, key for key).

A gang's members hash to shards independently (the shard map keys on
ns/uid), so a cohort generally spans several shards and no single shard's
local GangCoordinator can assemble it. The sharded daemon therefore holds
NOTHING locally (`_gang_holds` returns ""): gang rows admit and solve like
solo rows, and instead of committing, each member shard PUBLISHES its
solved members as entries on its own `ShardGangProposal` object — one
object per (gang, shard), so entry writes never contend across shards.

The gang's deterministic COORDINATOR shard (shardmap.shard_of_gang)
assembles entries until the cohort is complete, then commits every member
in ONE rv-checked `update_batch`:

- every member is re-read fresh; a missing member, or a member whose
  resource_version moved past the entry's `solved_rv`, VETOES the whole
  gang (outcome `aborted`) — the spec a shard solved against is no longer
  the spec in the store. The rv fence subsumes the per-shard epoch fence
  here: an epoch bump is always a store write, and a store write always
  moves the rv.
- a member that solved infeasible (or short of its full replica count)
  makes the gang jointly infeasible (outcome `rejected`): Scheduled=False
  conditions, exactly the local `_reject_gang` disposition.
- a cohort that never completes within the gang wait window times out
  (outcome `timeout`).

The coordinator stamps the outcome on every shard's proposal object;
member shards react to that watch event — re-admit their members UNCHARGED
on abort (queue `readd`: no retry charge, cached priority), settle on the
terminal outcomes — and the coordinator then deletes the proposals. The
binding store never holds a partial gang: nothing writes placements except
the coordinator's single fenced batch.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from ...api.meta import ObjectMeta
from ...api.sharding import (
    KIND_SHARD_GANG_PROPOSAL,
    SHARD_NAMESPACE,
    GangMemberEntry,
    GangProposalSpec,
    GangProposalStatus,
    ShardGangProposal,
    gang_proposal_name,
)
from ...api.work import (
    CONDITION_SCHEDULED,
    REASON_GANG_TIMEOUT,
    REASON_GANG_UNSCHEDULABLE,
)
from ...metrics import xshard_gang_commits
from ...store.store import BatchError, ConflictError, DELETED
from ...tracing import tracer
from ..core import ScheduleDecision
from ..queue import PrioritySchedulingQueue

log = logging.getLogger(__name__)

_CAS_ATTEMPTS = 16


class CrossShardGangs:
    """Both halves of the protocol for one shard's daemon: the member-side
    publisher (`publish`, called from the daemon's `_patch_gang` override
    on the writer thread) and the coordinator-side assembler (a worker
    thread driven level-triggered by proposal watch events + a periodic
    expiry tick). The worker only acts on gangs this shard coordinates."""

    def __init__(self, daemon, interval: float = 0.2) -> None:
        self.daemon = daemon
        self.interval = interval
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dirty = True  # level-triggered: scan on every wake
        daemon.store.watch(KIND_SHARD_GANG_PROPOSAL, self._on_proposal)

    # -- member side -------------------------------------------------------

    def publish(self, gname: str, items) -> None:
        """Merge this micro-batch's solved members of gang `gname` into
        the shard's proposal object. `items` = [(rb, decision), ...] with
        rb the drain-time snapshot each decision solved against."""
        daemon = self.daemon
        shard = daemon.shards.index
        gang_ns = items[0][0].metadata.namespace
        entries = []
        for rb, dec in items:
            entries.append(GangMemberEntry(
                key=rb.metadata.key(),
                uid=rb.metadata.uid,
                solved_rv=rb.metadata.resource_version,
                targets=[[t.name, t.replicas] for t in (dec.targets or [])],
                affinity_name=dec.affinity_name,
                error=dec.error,
                feasible=daemon._gang_full(rb, dec),
            ))
        size = max(max((rb.spec.gang_size or 0) for rb, _ in items), 1)
        name = gang_proposal_name(gang_ns, gname, shard)
        for _ in range(_CAS_ATTEMPTS):
            cur = daemon.store.try_get(KIND_SHARD_GANG_PROPOSAL, name,
                                       SHARD_NAMESPACE)
            try:
                if cur is None:
                    daemon.store.create(ShardGangProposal(
                        metadata=ObjectMeta(name=name,
                                            namespace=SHARD_NAMESPACE),
                        spec=GangProposalSpec(
                            gang_name=gname, gang_ns=gang_ns,
                            gang_size=size, shard=shard,
                            coordinator=daemon.shards.coordinator(
                                gang_ns, gname),
                            entries=entries,
                            created_at=daemon.clock.now(),
                        ),
                    ))
                    return
                if cur.status.outcome:
                    # terminal proposal racing deletion: the members just
                    # re-solved — re-admit them; the next drain republishes
                    # onto a fresh object
                    self._member_dispose(cur.status.outcome, entries)
                    return
                merged = {e.key: e for e in cur.spec.entries}
                for e in entries:
                    merged[e.key] = e  # a re-solve supersedes its old entry
                cur.spec.entries = list(merged.values())
                daemon.store.update(cur, check_rv=True)
                return
            except ConflictError:
                continue
        log.error("gang %s shard %d: proposal CAS contention", gname, shard)

    def _member_dispose(self, outcome: str, entries) -> None:
        """Member-shard disposition of its entries once the coordinator
        stamped a terminal outcome."""
        daemon = self.daemon
        q = daemon.controller.queue
        for e in entries:
            key = e.key
            if outcome == "aborted":
                # a veto re-admits the whole gang UNCHARGED: readd keeps
                # the cached priority and burns no retry budget
                readd = getattr(q, "readd", None) or q.add
                readd(key)
                continue
            if daemon.admission.enabled:
                if outcome == "committed":
                    lat = daemon.admission.observe_patch(
                        key, daemon.clock.now())
                    tracer.finish_placement(key, lat)
                else:
                    daemon.admission.settle(key)
            if outcome in ("rejected", "timeout") and isinstance(
                    q, PrioritySchedulingQueue):
                q.push_unschedulable(key)

    # -- watch + worker ----------------------------------------------------

    def _on_proposal(self, event: str, prop: ShardGangProposal) -> None:
        if (event != DELETED and prop.status.outcome
                and prop.spec.shard == self.daemon.shards.index):
            # our shard's entries reached a terminal outcome: dispose on
            # the dispatch thread (queue/admission ops are thread-safe)
            self._member_dispose(prop.status.outcome, prop.spec.entries)
        with self._cond:
            self._dirty = True
            self._cond.notify_all()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        with self._cond:
            self._dirty = True  # takeover: scan proposals already pending
        self._thread = threading.Thread(
            target=self._run,
            name=f"xshard-gangs-{self.daemon.shards.index}", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the coordinator worker (leadership loss). The proposal
        WATCH stays attached: the member-side disposition must keep
        running — a standby's members still need their re-admit/settle
        when some other shard's coordinator resolves their gang."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def detach(self) -> None:
        """Full teardown: stop the worker AND unsubscribe the watch."""
        self.stop()
        try:
            self.daemon.store.unwatch(KIND_SHARD_GANG_PROPOSAL,
                                      self._on_proposal)
        except Exception:  # noqa: BLE001 - double-detach is fine
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._dirty:
                    self._cond.wait(timeout=self.interval)
                self._dirty = False
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the worker must survive
                log.exception("cross-shard gang coordinator tick")

    # -- coordinator side --------------------------------------------------

    def tick(self) -> int:
        """One coordinator pass: assemble / commit / expire every gang this
        shard coordinates. Returns the number of gangs resolved (any
        terminal outcome). Also the test/bench drive — deterministic."""
        daemon = self.daemon
        gangs: dict[tuple[str, str], list] = {}
        for prop in daemon.store.list(KIND_SHARD_GANG_PROPOSAL,
                                      SHARD_NAMESPACE):
            if prop.status.outcome:
                continue
            gkey = (prop.spec.gang_ns, prop.spec.gang_name)
            if daemon.shards.coordinator(*gkey) != daemon.shards.index:
                continue
            gangs.setdefault(gkey, []).append(prop)
        resolved = 0
        for (gang_ns, gname), props in gangs.items():
            outcome = self._resolve(gang_ns, gname, props)
            if outcome:
                resolved += 1
                self._finish(props, outcome)
        return resolved

    def _resolve(self, gang_ns: str, gname: str, props: list) -> str:
        """Decide one gang: "" = keep waiting; else the terminal outcome
        (the commit, condition writes, and metrics happen here)."""
        daemon = self.daemon
        # dedupe entries by key (a resize can move a key between shards
        # mid-gang, leaving entries on both sides): the freshest solve wins
        by_key: dict[str, GangMemberEntry] = {}
        size = 1
        for prop in props:
            size = max(size, prop.spec.gang_size)
            for e in prop.spec.entries:
                old = by_key.get(e.key)
                if old is None or e.solved_rv >= old.solved_rv:
                    by_key[e.key] = e
        entries = list(by_key.values())
        if len(entries) < size:
            oldest = min(p.spec.created_at for p in props)
            if daemon.clock.now() - oldest > daemon.gangs.wait_seconds:
                self._write_conditions(
                    entries, REASON_GANG_TIMEOUT,
                    f"gang {gname} timed out waiting for members "
                    f"across shards")
                xshard_gang_commits.inc(outcome="timeout")
                return "timeout"
            return ""
        if not all(e.feasible and not e.error for e in entries):
            self._write_conditions(
                entries, REASON_GANG_UNSCHEDULABLE,
                f"gang {gname}: cohort did not place all {size} "
                f"members fully")
            xshard_gang_commits.inc(outcome="rejected")
            return "rejected"
        # the fenced commit: fresh batch read, rv fence per member, ONE
        # rv-checked batch write — nothing partial can reach the store
        pairs = []
        for e in entries:
            ns, _, name = e.key.partition("/")
            pairs.append((name, ns))
        fresh_list = daemon.store.get_batch("ResourceBinding", pairs)
        sink: list = []
        for e, fresh in zip(entries, fresh_list):
            if fresh is None or fresh.metadata.resource_version != e.solved_rv:
                xshard_gang_commits.inc(outcome="aborted")
                return "aborted"
            from ...api.work import TargetCluster

            dec = ScheduleDecision(
                e.key,
                targets=[TargetCluster(name=n, replicas=r)
                         for n, r in e.targets],
                affinity_name=e.affinity_name,
            )
            if not daemon._patch_result(fresh, dec, fresh=fresh, sink=sink,
                                        any_shard=True):
                xshard_gang_commits.inc(outcome="aborted")
                return "aborted"
        try:
            objs = [obj for obj, _ in sink]
            if objs:
                daemon.store.update_batch(objs, check_rv=True)
        except BatchError:
            xshard_gang_commits.inc(outcome="aborted")
            return "aborted"
        for obj, dec in sink:
            if dec is not None:
                daemon._record_event(obj, dec)
        xshard_gang_commits.inc(outcome="committed")
        return "committed"

    def _write_conditions(self, entries, reason: str, message: str) -> None:
        """Terminal rejection: Scheduled=False on every member we have an
        entry for (idempotent — the event fixpoint terminates)."""
        from ...api.meta import Condition, set_condition

        daemon = self.daemon
        for e in entries:
            ns, _, name = e.key.partition("/")
            fresh = daemon.store.try_get("ResourceBinding", name, ns)
            if fresh is None or fresh.metadata.deletion_timestamp is not None:
                continue
            if set_condition(
                fresh.status.conditions,
                Condition(type=CONDITION_SCHEDULED, status="False",
                          reason=reason, message=message),
            ):
                daemon.store.update(fresh)

    def _finish(self, props: list, outcome: str) -> None:
        """Stamp every shard's proposal with the outcome (the member
        shards' disposition trigger), then delete them."""
        daemon = self.daemon
        for prop in props:
            for _ in range(_CAS_ATTEMPTS):
                cur = daemon.store.try_get(
                    KIND_SHARD_GANG_PROPOSAL, prop.name, SHARD_NAMESPACE)
                if cur is None:
                    break
                cur.status = GangProposalStatus(outcome=outcome)
                try:
                    daemon.store.update(cur, check_rv=True)
                    break
                except ConflictError:
                    continue
            try:
                daemon.store.delete(KIND_SHARD_GANG_PROPOSAL, prop.name,
                                    SHARD_NAMESPACE)
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
