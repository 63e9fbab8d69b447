"""Deterministic shard map: rendezvous hashing of bindings onto slots (the
port's copy of the reference's sched/shards/shardmap.py: the same blake2b
score, so both packages put every key on the same slot).

Every participant — N shard leaders, their standbys, the CLI — must agree
on which shard owns a binding WITHOUT a coordination round, and a resize
from N to N+1 shards must move only ~1/(N+1) of the keyspace (a modulo
ring would reshuffle nearly everything). Rendezvous (highest-random-weight)
hashing gives both for free: each key scores every slot with a keyed hash
and the argmax owns it. Adding a slot moves exactly the keys whose new
slot's score beats their old argmax — in expectation 1/(N+1) of them —
and removing a slot moves only the removed slot's keys. No state, no
bounded-movement bookkeeping to replicate or persist.

Keys hash on `namespace/uid`, not name: a delete→recreate of the same
ns/name mints a new uid and may land on a different shard, which is safe
(the tombstone and the recreate are distinct keys to the admission log
too) — while a stable binding never migrates except at resize.
"""
from __future__ import annotations

import hashlib


def _score(slot: int, key: str) -> int:
    """The (slot, key) rendezvous weight: 8 bytes of blake2b, keyed by the
    slot index. Stable across processes and Python versions (never use
    hash() here — PYTHONHASHSEED would split the fleet's view)."""
    h = hashlib.blake2b(
        f"{slot}:{key}".encode("utf-8", "surrogatepass"), digest_size=8
    )
    return int.from_bytes(h.digest(), "big")


def shard_of(key: str, total: int) -> int:
    """The owning shard slot for `key` among `total` slots."""
    if total <= 1:
        return 0
    return max(range(total), key=lambda s: _score(s, key))


def shard_of_binding(rb, total: int) -> int:
    """Owner slot for a ResourceBinding: hashes namespace/uid (falls back
    to the ns/name key for objects minted without a uid, e.g. bare test
    fixtures — still deterministic, just resize-coupled to the name)."""
    ns = rb.metadata.namespace
    ident = rb.metadata.uid or rb.metadata.name
    return shard_of(f"{ns}/{ident}", total)


def shard_of_gang(gang_ns: str, gang_name: str, total: int) -> int:
    """The gang's COORDINATOR slot: the shard that assembles and commits a
    cross-shard cohort. Hashed on the gang identity (not any member's uid)
    so every member shard independently names the same coordinator."""
    return shard_of(f"gang:{gang_ns}/{gang_name}", total)


class ShardMap:
    """A (total, index) view of the rendezvous map: `mine(rb)` is the
    ownership predicate a ShardedDaemon gates admission on. `total` and
    `index` are plain attributes — a resize swaps them atomically under
    the GIL and the next gate evaluation sees the new map (the handoff
    protocol in daemon.py drives the re-admit/invalidate around that
    swap)."""

    def __init__(self, index: int, total: int) -> None:
        if total < 1:
            raise ValueError(f"shard total must be >= 1, got {total}")
        if not 0 <= index < total:
            raise ValueError(f"shard index {index} out of range for "
                             f"{total} slots")
        self.index = index
        self.total = total

    def mine(self, rb) -> bool:
        return shard_of_binding(rb, self.total) == self.index

    def owner(self, rb) -> int:
        return shard_of_binding(rb, self.total)

    def coordinator(self, gang_ns: str, gang_name: str) -> int:
        return shard_of_gang(gang_ns, gang_name, self.total)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ShardMap(index={self.index}, total={self.total})"
