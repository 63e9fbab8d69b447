"""SpreadConstraint selection: multi-dimensional HA group choice (PyTorch
port: a copy of the JAX package's sched/spread.py, numpy only).

Parity with pkg/scheduler/core/spreadconstraint (SCH8): group scoring
(group_clusters.go:138-330), cluster-only selection with the
availability-swap repair (select_clusters_by_cluster.go:46-99), region
selection via the exact DFS over group combinations with pruning and
weight>value>id path ranking + subpath preference (select_groups.go:100-230,
select_clusters_by_region.go:28-119). Only cluster and region constraints
are implemented — matching the reference, which errors on provider/zone-only
combinations (select_clusters.go:59).

Two implementations of the same semantics:
- the ClusterDetail list functions below are the readable spec (and what the
  parity tests exercise directly);
- `select_by_spread_arrays` is the hot path the scheduler core calls: group
  membership, availability sums and group scores are numpy array ops over the
  kernel's score/avail rows (one lexsort + cumsums per row) — no per-cluster
  Python object is ever built, which is what makes 5k spread rows × 5k
  clusters per round viable. Only the group-combination DFS stays
  combinatorial (SURVEY §7 hard parts; group counts are small).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..api.policy import (
    DIVISION_PREFERENCE_WEIGHTED,
    Placement,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_REGION,
    SpreadConstraint,
)

INVALID_REPLICAS = -1
WEIGHT_UNIT = 1000


class SpreadError(Exception):
    pass


@dataclass
class ClusterDetail:
    name: str
    index: int  # position in the fleet arrays (deterministic tie-break)
    score: int
    available: int  # estimator avail + own assigned replicas
    region: str = ""
    zone: str = ""
    provider: str = ""


def should_ignore_spread_constraint(placement: Placement) -> bool:
    """Static-weighted division ignores spread constraints
    (select_clusters.go:63-77)."""
    rs = placement.replica_scheduling
    if (
        rs is not None
        and rs.replica_scheduling_type == REPLICA_SCHEDULING_DIVIDED
        and rs.replica_division_preference == DIVISION_PREFERENCE_WEIGHTED
        and (
            rs.weight_preference is None
            or (rs.weight_preference.static_weight_list and not rs.weight_preference.dynamic_weight)
        )
    ):
        return True
    return False


def should_ignore_available_resource(placement: Placement) -> bool:
    """Duplicated ignores availability during selection (select_clusters.go:79-88)."""
    rs = placement.replica_scheduling
    return rs is None or rs.replica_scheduling_type == REPLICA_SCHEDULING_DUPLICATED


def sort_details(details: list[ClusterDetail], avail_desc: bool = True) -> list[ClusterDetail]:
    """sortClusters (util.go:43-57): score desc, then avail desc, then name."""
    if avail_desc:
        return sorted(details, key=lambda d: (-d.score, -d.available, d.name))
    return sorted(details, key=lambda d: (-d.score, d.name))


def calc_group_score_duplicated(clusters: list[ClusterDetail], replicas: int) -> int:
    """calcGroupScoreForDuplicate (group_clusters.go:143-215):
    validClusters*1000 + avg(valid scores)."""
    valid = [c for c in clusters if c.available >= replicas]
    if not valid:
        return 0
    return len(valid) * WEIGHT_UNIT + sum(c.score for c in valid) // len(valid)


def calc_group_score_divided(
    clusters: list[ClusterDetail],
    replicas: int,
    min_groups: int,
    cluster_min_groups: int,
) -> int:
    """calcGroupScore divided branch (group_clusters.go:217-330)."""
    target = math.ceil(replicas / max(min_groups, 1))
    need = max(cluster_min_groups, min_groups)
    sum_avail = sum_score = valid = 0
    for c in clusters:  # clusters already sorted score desc, avail desc
        sum_avail += c.available
        sum_score += c.score
        valid += 1
        if valid >= need and sum_avail >= target:
            break
    if sum_avail < target:
        return sum_avail * WEIGHT_UNIT + sum_score // len(clusters)
    return target * WEIGHT_UNIT + sum_score // valid


def _constraint_map(constraints: Sequence[SpreadConstraint]) -> dict[str, SpreadConstraint]:
    return {c.spread_by_field: c for c in constraints}


def select_clusters_by_spread(
    details: list[ClusterDetail],
    placement: Placement,
    replicas: int,
) -> list[ClusterDetail]:
    """SelectBestClusters (select_clusters.go:29-60). `details` must be the
    feasible clusters with device-computed score/avail. Raises SpreadError
    when constraints cannot be met."""
    constraints = placement.spread_constraints
    details = sort_details(details)
    if not constraints or should_ignore_spread_constraint(placement):
        return details

    cmap = _constraint_map(constraints)
    if SPREAD_BY_FIELD_REGION in cmap:
        return _select_by_region(cmap, details, placement, replicas)
    if SPREAD_BY_FIELD_CLUSTER in cmap:
        need_replicas = (
            INVALID_REPLICAS if should_ignore_available_resource(placement) else replicas
        )
        return _select_by_cluster(cmap[SPREAD_BY_FIELD_CLUSTER], details, need_replicas)
    raise SpreadError("just support cluster and region spread constraint")


# -- cluster-only (select_clusters_by_cluster.go) ---------------------------


def _select_by_cluster(
    constraint: SpreadConstraint,
    details: list[ClusterDetail],
    need_replicas: int,
) -> list[ClusterDetail]:
    total = len(details)
    if total < constraint.min_groups:
        raise SpreadError(
            "the number of feasible clusters is less than spreadConstraint.MinGroups"
        )
    need_cnt = constraint.max_groups if constraint.max_groups > 0 else total
    need_cnt = min(need_cnt, total)
    if need_replicas == INVALID_REPLICAS:
        return details[:need_cnt]
    selected = _select_by_available_resource(details, need_cnt, need_replicas)
    if not selected:
        raise SpreadError(f"no enough resource when selecting {need_cnt} clusters")
    return selected


def _select_by_available_resource(
    candidates: list[ClusterDetail], need_cnt: int, need_replicas: int
) -> list[ClusterDetail]:
    """selectClustersByAvailableResource (select_clusters_by_cluster.go:66-88):
    start from the top-scored prefix; while capacity is short, replace the
    lowest-scored kept cluster with the biggest-capacity rest cluster."""
    ret = list(candidates[:need_cnt])
    rest = list(candidates[need_cnt:])
    update_idx = len(ret) - 1
    while sum(c.available for c in ret) < need_replicas and update_idx >= 0:
        best = None
        for i, c in enumerate(rest):
            if c.available > ret[update_idx].available and (
                best is None or c.available > rest[best].available
            ):
                best = i
        if best is None:
            update_idx -= 1
            continue
        ret[update_idx], rest[best] = rest[best], ret[update_idx]
        update_idx -= 1
    if sum(c.available for c in ret) < need_replicas:
        return []
    return ret


# -- region (select_clusters_by_region.go + select_groups.go) ---------------


@dataclass
class _Group:
    name: str
    value: int  # number of clusters
    weight: int  # group score
    clusters: list[ClusterDetail] = field(default_factory=list)
    available: int = 0


def _select_by_region(
    cmap: dict[str, SpreadConstraint],
    details: list[ClusterDetail],
    placement: Placement,
    replicas: int,
) -> list[ClusterDetail]:
    region_constraint = cmap[SPREAD_BY_FIELD_REGION]
    cluster_constraint = cmap.get(SPREAD_BY_FIELD_CLUSTER, SpreadConstraint(min_groups=0))

    regions: dict[str, _Group] = {}
    for c in details:  # details sorted; region cluster lists inherit order
        if not c.region:
            continue
        g = regions.setdefault(c.region, _Group(name=c.region, value=0, weight=0))
        g.clusters.append(c)
        g.value += 1
        g.available += c.available

    if len(regions) < region_constraint.min_groups:
        raise SpreadError("the number of feasible region is less than spreadConstraint.MinGroups")

    duplicated = should_ignore_available_resource(placement)
    for g in regions.values():
        if duplicated:
            g.weight = calc_group_score_duplicated(g.clusters, replicas)
        else:
            g.weight = calc_group_score_divided(
                g.clusters,
                replicas,
                max(region_constraint.min_groups, 1),
                cluster_constraint.min_groups,
            )

    chosen = _select_groups(
        list(regions.values()),
        region_constraint.min_groups,
        region_constraint.max_groups if region_constraint.max_groups > 0 else len(regions),
        cluster_constraint.min_groups,
    )
    if not chosen:
        raise SpreadError("the number of clusters is less than the cluster spreadConstraint.MinGroups")

    # best cluster per selected region, then fill by score (avail tie-break)
    selected = [g.clusters[0] for g in chosen]
    candidates: list[ClusterDetail] = []
    for g in chosen:
        candidates.extend(g.clusters[1:])
    need_cnt = len(selected) + len(candidates)
    if cluster_constraint.max_groups > 0:
        need_cnt = min(need_cnt, cluster_constraint.max_groups)
    rest_cnt = need_cnt - len(selected)
    if rest_cnt > 0:
        selected.extend(sort_details(candidates)[:rest_cnt])
    return selected


# -- array fast path (scheduler core) ---------------------------------------


@dataclass
class _ArrayGroup:
    """Region group over positions into the row's sorted feasible arrays.
    Duck-types _Group for the shared DFS (value/weight/name)."""

    name: str
    value: int
    weight: int
    positions: np.ndarray = None
    available: int = 0


def select_by_spread_arrays(
    feas_idx: np.ndarray,  # i64[N] fleet indices of the row's feasible clusters
    score: np.ndarray,  # i32[N] kernel score row
    available: np.ndarray,  # i64[N] kernel avail + own previous replicas
    name_rank: np.ndarray,  # i32[N] cluster-name ascending rank (tie-break)
    region_id: np.ndarray,  # i32[N] region id, -1 = none
    region_names: Sequence[str],  # id → region name (group-id tie-break)
    placement: Placement,
    replicas: int,
) -> np.ndarray:
    """Array equivalent of select_clusters_by_spread: returns the SELECTED
    fleet indices. Semantics identical to the ClusterDetail path (parity
    tested); no per-cluster objects are built.

    Callers feed per-FEASIBLE-cluster arrays; the indices only name the
    clusters, so the compact candidate round (sched/candidates.py) passes
    its window-gathered slices directly — the selection is well-defined
    over ANY subset that contains the row's whole feasible set, and rows
    whose feasible set outruns the candidate window must re-solve dense
    before calling here (the loud spread_constraint fallback)."""
    available = available.astype(np.int64)
    # sortClusters (util.go:43-57): score desc, avail desc, name asc
    order = np.lexsort((name_rank, -available, -score))
    feas_idx = feas_idx[order]
    score = score[order]
    available = available[order]
    region_id = region_id[order]

    constraints = placement.spread_constraints
    if not constraints or should_ignore_spread_constraint(placement):
        return feas_idx

    cmap = _constraint_map(constraints)
    if SPREAD_BY_FIELD_REGION in cmap:
        return _region_arrays(
            cmap, feas_idx, score, available, region_id, region_names,
            placement, replicas,
        )
    if SPREAD_BY_FIELD_CLUSTER in cmap:
        need_replicas = (
            INVALID_REPLICAS if should_ignore_available_resource(placement) else replicas
        )
        return _cluster_arrays(
            cmap[SPREAD_BY_FIELD_CLUSTER], feas_idx, available, need_replicas
        )
    raise SpreadError("just support cluster and region spread constraint")


def _cluster_arrays(
    constraint: SpreadConstraint,
    feas_idx: np.ndarray,  # sorted
    available: np.ndarray,
    need_replicas: int,
) -> np.ndarray:
    """_select_by_cluster + the availability-swap repair
    (select_clusters_by_cluster.go:46-99) over arrays."""
    total = len(feas_idx)
    if total < constraint.min_groups:
        raise SpreadError(
            "the number of feasible clusters is less than spreadConstraint.MinGroups"
        )
    need_cnt = constraint.max_groups if constraint.max_groups > 0 else total
    need_cnt = min(need_cnt, total)
    if need_replicas == INVALID_REPLICAS:
        return feas_idx[:need_cnt]

    ret_pos = np.arange(need_cnt)
    rest_pos = np.arange(need_cnt, total)
    ret_av = available[:need_cnt].copy()
    rest_av = available[need_cnt:].copy()
    update = need_cnt - 1
    while ret_av.sum() < need_replicas and update >= 0:
        # reference picks the max-availability rest cluster strictly better
        # than the one being replaced; argmax's first-max == its choice
        if rest_av.size:
            best = int(np.argmax(rest_av))
            if rest_av[best] > ret_av[update]:
                ret_pos[update], rest_pos[best] = rest_pos[best], ret_pos[update]
                ret_av[update], rest_av[best] = rest_av[best], ret_av[update]
        update -= 1
    if ret_av.sum() < need_replicas:
        raise SpreadError(f"no enough resource when selecting {need_cnt} clusters")
    return feas_idx[ret_pos]


def _region_arrays(
    cmap: dict[str, SpreadConstraint],
    feas_idx: np.ndarray,  # all sorted by (score desc, avail desc, name asc)
    score: np.ndarray,
    available: np.ndarray,
    region_id: np.ndarray,
    region_names: Sequence[str],
    placement: Placement,
    replicas: int,
) -> np.ndarray:
    """_select_by_region over arrays: per-region membership/sums/scores via
    cumsums on the sorted row; DFS unchanged."""
    region_constraint = cmap[SPREAD_BY_FIELD_REGION]
    cluster_constraint = cmap.get(SPREAD_BY_FIELD_CLUSTER, SpreadConstraint(min_groups=0))

    has_region = region_id >= 0
    rids = region_id[has_region]
    positions = np.nonzero(has_region)[0]
    unique_rids = np.unique(rids)
    if len(unique_rids) < region_constraint.min_groups:
        raise SpreadError(
            "the number of feasible region is less than spreadConstraint.MinGroups"
        )

    duplicated = should_ignore_available_resource(placement)
    min_groups = max(region_constraint.min_groups, 1)
    need = max(cluster_constraint.min_groups, min_groups)
    target = math.ceil(replicas / min_groups)

    groups: list[_ArrayGroup] = []
    for rid in unique_rids:
        pos = positions[rids == int(rid)]  # ascending = global sorted order
        av = available[pos]
        sc = score[pos].astype(np.int64)
        n = len(pos)
        if duplicated:
            # calcGroupScoreForDuplicate (group_clusters.go:143-215)
            valid = av >= replicas
            cnt = int(valid.sum())
            weight = cnt * WEIGHT_UNIT + int(sc[valid].sum()) // cnt if cnt else 0
        else:
            # calcGroupScore divided branch (group_clusters.go:217-330):
            # prefix accumulation in sorted order with early stop
            cum_av = np.cumsum(av)
            cum_sc = np.cumsum(sc)
            cond = (np.arange(1, n + 1) >= need) & (cum_av >= target)
            if cond.any():
                k = int(np.argmax(cond))
                weight = target * WEIGHT_UNIT + int(cum_sc[k]) // (k + 1)
            elif int(cum_av[-1]) < target:
                weight = int(cum_av[-1]) * WEIGHT_UNIT + int(cum_sc[-1]) // n
            else:
                weight = target * WEIGHT_UNIT + int(cum_sc[-1]) // n
        groups.append(
            _ArrayGroup(
                name=region_names[int(rid)],
                value=n,
                weight=weight,
                positions=pos,
                available=int(av.sum()),
            )
        )

    chosen = _select_groups(
        groups,
        region_constraint.min_groups,
        region_constraint.max_groups if region_constraint.max_groups > 0 else len(groups),
        cluster_constraint.min_groups,
    )
    if not chosen:
        raise SpreadError(
            "the number of clusters is less than the cluster spreadConstraint.MinGroups"
        )

    # best cluster per selected region, then fill by score — candidate
    # positions ascending reproduce sort_details order exactly
    selected = [int(g.positions[0]) for g in chosen]
    candidates = np.sort(np.concatenate([g.positions[1:] for g in chosen]))
    need_cnt = len(selected) + len(candidates)
    if cluster_constraint.max_groups > 0:
        need_cnt = min(need_cnt, cluster_constraint.max_groups)
    rest_cnt = need_cnt - len(selected)
    if rest_cnt > 0:
        selected.extend(int(p) for p in candidates[:rest_cnt])
    return feas_idx[selected]


def _select_groups(
    groups: list[_Group], min_constraint: int, max_constraint: int, target: int
) -> list[_Group]:
    """selectGroups/findFeasiblePaths/prioritizePaths (select_groups.go:100-230):
    exact DFS over group combinations whose total cluster count covers
    `target`, path length within [min,max]; rank weight desc > value desc >
    id asc; prefer subpaths of the winner."""
    if not groups:
        return []
    groups = sorted(groups, key=lambda g: (g.value, -g.weight, g.name))
    min_constraint = max(min_constraint, 1)
    max_constraint = max(max_constraint, min_constraint)

    paths: list[tuple[int, list[_Group]]] = []
    path: list[_Group] = []
    counter = [0]

    def dfs(total: int, begin: int) -> None:
        if total >= target and min_constraint <= len(path) <= max_constraint:
            counter[0] += 1
            # groups within a recorded path sort by weight desc, name asc
            # (dfsPath.sortGroups) — subpath preference compares this order
            paths.append((counter[0], sorted(path, key=lambda g: (-g.weight, g.name))))
            return
        if len(path) >= max_constraint:
            return
        for i in range(begin, len(groups)):
            path.append(groups[i])
            dfs(total + groups[i].value, i + 1)
            if len(groups) == min_constraint:
                break
            path.pop()

    dfs(0, 0)
    if not paths:
        return []

    def rank(entry):
        pid, gs = entry
        return (-sum(g.weight for g in gs), -sum(g.value for g in gs), pid)

    paths.sort(key=rank)
    final = paths[0][1]
    for _, gs in paths[1:]:
        names = [g.name for g in gs]
        final_names = [g.name for g in final]
        if len(names) < len(final_names) and final_names[: len(names)] == names:
            final = gs
    return final
