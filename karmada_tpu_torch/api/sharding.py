"""Sharded-scheduler-plane kinds (the port's copy of the reference's
api/sharding.py; same kinds, fields and names, so both packages encode
them to the same wire bytes).

Two in-store objects back the shard subsystem (sched/shards/):

- `SchedulerShard` — one per shard slot, the status surface `karmadactl
  get shards` renders: current leader identity + lease token, queue depth,
  owned-binding count, last-solve time and handoff state. Published by the
  shard's leader from its idle loop; purely observational (the shard MAP is
  deterministic — rendezvous hash — so no assignment state lives here).
- `ShardGangProposal` — the cross-shard gang commit protocol's unit. A gang
  whose members hash to different shards cannot commit through one shard's
  local all-or-nothing `_patch_gang`; instead each member shard solves its
  own members and publishes their prepared placements as proposal ENTRIES
  (solved rv + targets + joint-feasibility verdict), and the gang's
  deterministic COORDINATOR shard (shardmap.shard_of_gang) assembles
  entries until the cohort is complete, then commits every member in ONE
  rv-checked `update_batch` — any member moving past its solved rv vetoes
  the whole gang (the local gang commit's semantics across shards). The coordinator stamps
  `status.outcome`; member shards react to that event (re-admit on abort,
  settle on commit) and the coordinator deletes the proposal afterwards.

Both kinds live in the `karmada-system` namespace, like the election
leases they complement.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

KIND_SCHEDULER_SHARD = "SchedulerShard"
KIND_SHARD_GANG_PROPOSAL = "ShardGangProposal"

# shard objects and gang proposals deploy next to the election leases
SHARD_NAMESPACE = "karmada-system"


def shard_lease_name(index: int) -> str:
    """Election lease for shard slot `index` — each slot elects its own
    streaming leader, independently of its siblings."""
    return f"karmada-sched-shard-{index}"


def shard_object_name(index: int) -> str:
    return f"scheduler-shard-{index}"


def gang_proposal_name(gang_ns: str, gang_name: str, shard: int) -> str:
    """One proposal object per (gang, member shard): entry writes never
    contend across shards — each shard owns its own proposal object and
    only the coordinator reads them all."""
    ns = gang_ns or "default"
    return f"gang-{ns}-{gang_name}-s{shard}"


@dataclass
class ShardStatus:
    leader: str = ""  # holder identity of the shard's lease ("" = no leader)
    fencing_token: int = 0
    epoch: int = 0  # admission epochs consumed by this shard's leader
    queue_depth: int = 0
    bindings: int = 0  # bindings the shard map currently assigns to the slot
    last_solve_time: float = 0.0
    # "" steady-state; "draining" while a resize moves keys off the slot,
    # "absorbing" while re-admitting a moved-in keyspace
    handoff: str = ""
    shards_total: int = 0


@dataclass
class SchedulerShard:
    kind: str = KIND_SCHEDULER_SHARD
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: ShardStatus = field(default_factory=ShardStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class GangMemberEntry:
    """One solved member inside a shard's proposal: everything the
    coordinator needs to re-prepare and commit the placement without
    re-solving — plus the rv fence that makes the commit honest."""

    key: str = ""  # namespace/name
    uid: str = ""
    solved_rv: int = 0  # the member's resource_version at solve time
    # (cluster, replicas) pairs — the ScheduleDecision targets flattened
    targets: list = field(default_factory=list)
    affinity_name: str = ""
    error: str = ""  # non-empty = this member solved infeasible
    feasible: bool = True  # _gang_full verdict (full replica placement)


@dataclass
class GangProposalSpec:
    gang_name: str = ""
    gang_ns: str = ""
    gang_size: int = 0
    shard: int = -1  # the member shard that published this proposal
    coordinator: int = -1  # shard_of_gang at publish time
    entries: list = field(default_factory=list)  # list[GangMemberEntry]
    created_at: float = 0.0  # coordinator-side expiry clock


@dataclass
class GangProposalStatus:
    # "" = pending assembly; terminal: committed | aborted | rejected |
    # timeout. Member shards key their disposition off this field's event.
    outcome: str = ""
    message: str = ""


@dataclass
class ShardGangProposal:
    kind: str = KIND_SHARD_GANG_PROPOSAL
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: GangProposalSpec = field(default_factory=GangProposalSpec)
    status: GangProposalStatus = field(default_factory=GangProposalStatus)

    @property
    def name(self) -> str:
        return self.metadata.name
