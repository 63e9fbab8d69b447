"""Sharded scheduler plane: N concurrent streaming leaders over disjoint
binding slices, with cross-shard gang commit (the port's copy of the
reference's sched/shards/; the leaders' rounds run on the card).

- shardmap: deterministic rendezvous hash of binding ns/uid onto shard
  slots — bounded movement on resize, no assignment state to replicate.
- daemon: ShardedDaemon (a SchedulerDaemon that owns only its slice) and
  ShardPlane (the in-process host running one leader stack per shard).
- gangs: the cross-shard all-or-nothing commit protocol over
  ShardGangProposal objects.
- fairness: the shared per-cluster estimator concurrency budget.
"""
from .shardmap import ShardMap, shard_of, shard_of_binding, shard_of_gang  # noqa: F401
from .daemon import ShardedDaemon, ShardPlane  # noqa: F401
from .fairness import ClusterFairnessBudget  # noqa: F401
