"""Estimator-server plugin framework + the ResourceQuota estimate plugin
(the port's copy of the reference's estimator/plugins.py). A framework
reaches the rounds through `AccurateEstimator(framework=)`: an estimator
with one makes `MemberEstimators` take the per-cluster host route, whose
answers feed the card's rounds as `extra_avail`.

Parity with pkg/estimator/server/framework:
- `RunEstimateReplicasPlugins` min-merges every plugin's answer into the
  node-level estimate (interface.go:31-41, runtime/framework.go:115-134);
- the ResourceQuota plugin bounds the answer by the namespace's free quota
  (hard − used over compute resources), honoring the PriorityClass scope
  and gated by the ResourceQuotaEstimate feature
  (plugins/resourcequota/resourcequota.go:47-180).

The result/merge state machine is kept bit-for-bit: Error > Unschedulable >
all-NoOperation > Success (interface.go:118-152); plugin answers count into
the min only on Success or Unschedulable (runtime/framework.go:126-131).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence

from ..api.meta import Resources
from ..api.work import ReplicaRequirements
from ..features import RESOURCE_QUOTA_ESTIMATE, FeatureGates, default_gates
from ..models.fleet import to_int_units

MAX_INT32 = 2**31 - 1

# Result codes (framework/interface.go:84-97)
SUCCESS = 0
UNSCHEDULABLE = 1
NO_OPERATION = 2
ERROR = 3

_CODE_NAMES = ["Success", "Unschedulable", "Nooperation", "Error"]


@dataclass
class Result:
    code: int = SUCCESS
    reasons: list[str] = field(default_factory=list)
    err: Optional[str] = None

    @property
    def is_success(self) -> bool:
        return self.code == SUCCESS

    @property
    def is_unschedulable(self) -> bool:
        return self.code == UNSCHEDULABLE

    @property
    def is_noop(self) -> bool:
        return self.code == NO_OPERATION

    def name(self) -> str:
        return _CODE_NAMES[self.code]


def merge_results(results: dict[str, Result]) -> Result:
    """PluginToResult.Merge (interface.go:118-152)."""
    if not results:
        return Result(NO_OPERATION, ["plugin results are empty"])
    final = Result(SUCCESS)
    has_unschedulable = False
    all_noop = True
    for r in results.values():
        if r.code == ERROR:
            final.err = r.err
        elif r.code == UNSCHEDULABLE:
            has_unschedulable = True
        if r.code != NO_OPERATION:
            all_noop = False
        final.reasons.extend(r.reasons)
    if final.err is not None:
        final.code = ERROR
    elif has_unschedulable:
        final.code = UNSCHEDULABLE
    elif all_noop:
        final.code = NO_OPERATION
    else:
        final.code = SUCCESS
    return final


class EstimateReplicasPlugin(Protocol):
    name: str

    def estimate(
        self, requirements: Optional[ReplicaRequirements]
    ) -> tuple[int, Result]:
        """Replica bound for the given requirements; MAX_INT32 = no opinion."""
        ...


class EstimatorFramework:
    """The configured plugin set of one estimator server
    (runtime/framework.go frameworkImpl)."""

    def __init__(self, plugins: Sequence[EstimateReplicasPlugin] = ()):
        self.plugins = list(plugins)

    def run_estimate_replicas_plugins(
        self, requirements: Optional[ReplicaRequirements]
    ) -> tuple[int, Result]:
        replica = MAX_INT32
        results: dict[str, Result] = {}
        for pl in self.plugins:
            pl_replica, ret = pl.estimate(requirements)
            if (ret.is_success or ret.is_unschedulable) and pl_replica < replica:
                replica = pl_replica
            results[pl.name] = ret
        return replica, merge_results(results)


# -- ResourceQuota plugin ----------------------------------------------------

# quota scope names (corev1.ResourceQuotaScope*)
SCOPE_TERMINATING = "Terminating"
SCOPE_NOT_TERMINATING = "NotTerminating"
SCOPE_BEST_EFFORT = "BestEffort"
SCOPE_NOT_BEST_EFFORT = "NotBestEffort"
SCOPE_PRIORITY_CLASS = "PriorityClass"
SCOPE_CROSS_NS_AFFINITY = "CrossNamespacePodAffinity"

SCOPE_OP_IN = "In"
SCOPE_OP_NOT_IN = "NotIn"
SCOPE_OP_EXISTS = "Exists"
SCOPE_OP_DOES_NOT_EXIST = "DoesNotExist"

_REQUESTS_PREFIX = "requests."
_LIMITS_PREFIX = "limits."

# computeResources (resourcequota.go:306-313): only these quota rows bound
# pod replicas; storage/object-count rows are skipped
_COMPUTE_RESOURCES = frozenset(
    ["cpu", "memory", "requests.cpu", "requests.memory",
     "limits.cpu", "limits.memory"]
)


@dataclass
class ScopedSelectorRequirement:
    scope_name: str
    operator: str = SCOPE_OP_EXISTS
    values: list[str] = field(default_factory=list)


@dataclass
class ResourceQuota:
    """Member-side v1.ResourceQuota slice: the spec scopes + status
    hard/used rows the estimator consumes (keys are quota resource names
    like "requests.cpu"; values in the float units of api.meta.Resources)."""

    name: str
    namespace: str
    scopes: list[str] = field(default_factory=list)
    scope_selector: list[ScopedSelectorRequirement] = field(default_factory=list)
    hard: Resources = field(default_factory=dict)
    used: Resources = field(default_factory=dict)


def _matches_scope(sel: ScopedSelectorRequirement, priority_class: str) -> bool:
    """matchesScope (resourcequota.go:240-265): only the PriorityClass scope
    can match; every other scope rejects the quota."""
    if sel.scope_name != SCOPE_PRIORITY_CLASS:
        return False
    if sel.operator == SCOPE_OP_EXISTS:
        return bool(priority_class)
    if sel.operator == SCOPE_OP_IN:
        return priority_class in sel.values
    if sel.operator == SCOPE_OP_NOT_IN:
        return bool(priority_class) and priority_class not in sel.values
    if sel.operator == SCOPE_OP_DOES_NOT_EXIST:
        return not priority_class
    return False


def _is_extended_resource(name: str) -> bool:
    """corev1helper.IsExtendedResourceName: a domain-qualified name outside
    the kubernetes.io native namespace (nvidia.com/gpu etc.). Prefixed-native
    domains like node.kubernetes.io/* CONTAIN kubernetes.io and are not
    extended (IsPrefixedNativeResource uses a contains check)."""
    return (
        "/" in name
        and "kubernetes.io/" not in name
        and not name.startswith(_REQUESTS_PREFIX)
        and not name.startswith(_LIMITS_PREFIX)
    )


def _matches_compute(rname: str) -> bool:
    """matchingResources (resourcequota.go:306-335): the fixed compute set
    plus extended resources, bare or requests./limits.-prefixed."""
    if rname in _COMPUTE_RESOURCES:
        return True
    base = rname
    for pref in (_REQUESTS_PREFIX, _LIMITS_PREFIX):
        if rname.startswith(pref):
            base = rname[len(pref):]
            break
    return _is_extended_resource(base)


def _free_resources(rq: ResourceQuota) -> dict[str, float]:
    """calculateFreeResources (resourcequota.go:185-215): hard − used over
    matching compute/extended rows; limits.* skipped; requests.* merged with
    the bare name (requests.cpu == cpu)."""
    free: dict[str, float] = {}
    for rname in rq.hard:
        if not _matches_compute(rname):
            continue
        if rname.startswith(_LIMITS_PREFIX):
            continue
        if rname not in rq.used:
            continue
        trimmed = rname[len(_REQUESTS_PREFIX):] if rname.startswith(
            _REQUESTS_PREFIX) else rname
        free[trimmed] = rq.hard[rname] - rq.used[rname]
    return free


def _max_divided(free: dict[str, float], request: Resources) -> int:
    """util.Resource.MaxDivided over the quota-covered request rows
    (resourcequota.go:157-180): resources absent from the quota don't
    constrain; integer division in canonical units."""
    allowed = 2**63 - 1
    for rname, req in request.items():
        if rname not in free:
            continue
        req_units = to_int_units(rname, req)
        if req_units <= 0:
            continue
        free_units = max(to_int_units(rname, free[rname]), 0)
        allowed = min(allowed, free_units // req_units)
    return allowed


class ResourceQuotaEstimatorPlugin:
    """plugins/resourcequota (resourcequota.go:47-135). `quota_lister` is a
    callable namespace -> quotas (the informer-lister seam; tests and the
    member store both fit)."""

    name = "ResourceQuotaEstimator"

    def __init__(
        self,
        quota_lister: Callable[[str], Sequence[ResourceQuota]],
        gates: Optional[FeatureGates] = None,
    ):
        self.quota_lister = quota_lister
        self.gates = gates or default_gates

    @property
    def enabled(self) -> bool:
        return self.gates.enabled(RESOURCE_QUOTA_ESTIMATE)

    def estimate(
        self, requirements: Optional[ReplicaRequirements]
    ) -> tuple[int, Result]:
        replica = MAX_INT32
        if not self.enabled:
            return replica, Result(
                NO_OPERATION, [f"{self.name} is disabled"]
            )
        namespace = requirements.namespace if requirements else ""
        priority_class = (
            requirements.priority_class_name if requirements else ""
        )
        request = requirements.resource_request if requirements else {}
        for rq in self.quota_lister(namespace):
            # scope selection (getScopeSelectorsFromQuota): spec.scopes as
            # Exists requirements + explicit scopeSelector expressions; the
            # FIRST matching selector with compute rows binds the quota
            selectors = [
                ScopedSelectorRequirement(scope_name=s) for s in rq.scopes
            ] + list(rq.scope_selector)
            # NOTE (parity): an UNscoped quota yields no selectors and thus
            # never constrains — the reference evaluator only ever matches
            # the PriorityClass scope (resourcequota.go:132-151, 240-265)
            for sel in selectors:
                if not _matches_scope(sel, priority_class):
                    continue
                free = _free_resources(rq)
                if not free:
                    continue
                allowed = _max_divided(free, request)
                if allowed > MAX_INT32:
                    break  # avoid the int32 overflow (resourcequota.go:171)
                if allowed < replica:
                    replica = int(allowed)
                break
        if replica == MAX_INT32:
            return replica, Result(
                NO_OPERATION,
                [f"{self.name} has no operation on input replicaRequirements"],
            )
        if replica == 0:
            return replica, Result(
                UNSCHEDULABLE, [f"zero replica is estimated by {self.name}"]
            )
        return replica, Result(SUCCESS)
