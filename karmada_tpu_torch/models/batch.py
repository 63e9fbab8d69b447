"""Per-round binding batch encoding: dirty ResourceBindings → dense arrays.

The reference schedules one binding at a time (scheduler.go:375-443); the
batched build gathers all dirty bindings of a round into one [B,...] batch. String
work (affinity/label selectors, static-weight rule matching) happens here on
host with per-policy dedup; the device sees only ids, masks and integers.

Strategy codes mirror newAssignState's dispatch (core/assignment.go:89-117):
  0 NON_WORKLOAD (spec.replicas <= 0 → all candidates, no counts,
    core/common.go:68-75)
  1 DUPLICATED
  2 STATIC_WEIGHT
  3 DYNAMIC_WEIGHT
  4 AGGREGATED
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..api.policy import (
    DIVISION_PREFERENCE_AGGREGATED,
    DIVISION_PREFERENCE_WEIGHTED,
    Placement,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
)
from ..api.work import ResourceBinding
from ..sched.affinity import AffinityMaskCache, affinity_key
from .fleet import EFFECT_CODES, FleetArrays, FleetEncoder, to_int_units
from ..ops.filters import TOL_OP_EQUAL, TOL_OP_EXISTS

NON_WORKLOAD = 0
DUPLICATED = 1
STATIC_WEIGHT = 2
DYNAMIC_WEIGHT = 3
AGGREGATED = 4


def strategy_code(placement: Optional[Placement], replicas: int) -> int:
    if replicas <= 0:
        return NON_WORKLOAD
    if placement is None or placement.replica_scheduling is None:
        return DUPLICATED
    rs = placement.replica_scheduling
    if rs.replica_scheduling_type == REPLICA_SCHEDULING_DUPLICATED:
        return DUPLICATED
    if rs.replica_scheduling_type == REPLICA_SCHEDULING_DIVIDED:
        if rs.replica_division_preference == DIVISION_PREFERENCE_AGGREGATED:
            return AGGREGATED
        if rs.replica_division_preference == DIVISION_PREFERENCE_WEIGHTED:
            if rs.weight_preference is not None and rs.weight_preference.dynamic_weight:
                return DYNAMIC_WEIGHT
            return STATIC_WEIGHT
    return DUPLICATED


def pow2_bucket(n: int, lo: int = 2) -> int:
    """Smallest power of two >= n, starting at lo — THE jit-cache bucketing
    rule (shared so the policy can't drift between call sites)."""
    b = lo
    while b < n:
        b *= 2
    return b


def shape_bucket(n: int, lo: int = 8) -> int:
    """Smallest pow2/1.5×pow2 lattice point >= n, switching to 1024-multiples
    past 4096 — THE shape-bucketing rule for the batch row axis B and the
    fleet column axis C (sched/core.py pads both to it). The 1.5× midpoints
    cap pad waste at 25% (pure pow2 wastes up to 50%) while the lattice stays
    small enough to bound the jit cache AND to be enumerable by the AOT
    prewarm pass (sched/aot.py); above 4096 the 1024-step keeps waste under
    ~2.5% where the solve volume — O(B·C) — makes pad rows wall-clock."""
    b = lo
    while b < n and b < 4096:
        h = b + b // 2
        if n <= h:
            return h
        b *= 2
    if n <= b:
        return b
    return ((n + 1023) // 1024) * 1024


def shape_floor(cap: int, lo: int = 8) -> int:
    """Largest shape_bucket lattice point <= cap (never below lo) — row caps
    floor to it so every full chunk of a chunked round hits one compiled
    shape."""
    if cap >= 4096:
        return (cap // 1024) * 1024
    b, best = lo, lo
    while b <= cap:
        best = b
        if b + b // 2 <= cap:
            best = b + b // 2
        b *= 2
    return best


def uid_seed(uid: str) -> np.uint64:
    return np.frombuffer(hashlib.blake2b(uid.encode(), digest_size=8).digest(), np.uint64)[0]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — stateless deterministic tie-break randomness."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def tie_matrix(uids: Sequence[str], n_clusters: int) -> np.ndarray:
    """Deterministic replacement for the crypto-rand tie-break
    (binding.go:74-79): per-(binding,cluster) pseudo-random i32 derived from
    the binding UID, independent of batch composition."""
    seeds = np.array([uid_seed(u) for u in uids], np.uint64)[:, None]
    idx = np.arange(1, n_clusters + 1, dtype=np.uint64)[None, :]
    return (_mix64(seeds ^ idx) >> np.uint64(33)).astype(np.int32)


@dataclass
class BindingBatch:
    """Transfer-compact batch: the [B,C] tensors the solve needs are stored
    factored — policy-level tables + per-binding indices + sparse previous/
    eviction entries + a tie seed — and reconstructed ON DEVICE
    (the candidate-select kernel reads the tables directly). Host→device
    traffic per round is O(B·K + P·C) instead of O(B·C); at 10k×5k that is
    ~3 MB instead of ~1.3 GB.

    Dense views (`affinity_ok`, `static_weight`, ...) are materialized lazily
    for the mesh path and tests."""

    keys: list[str]  # namespace/name per row
    uids: list[str]
    # core tensors
    replicas: np.ndarray  # i32[B]
    unknown_request: np.ndarray  # bool[B] request names outside the resource
    #   vocabulary ⇒ estimators must report 0 (missing allocatable key → 0,
    #   general.go:166-169)
    gvk: np.ndarray  # i32[B]
    strategy: np.ndarray  # i32[B]
    fresh: np.ndarray  # bool[B]
    # tolerations, factored like the policy tables: distinct toleration ROWS
    # (key/value/effect/op stacked) in one [T,4,K] table + a per-row index —
    # the dense [B,K]x4 form was >1 MB of host→device upload per flagship
    # round
    tol_tables: np.ndarray  # i32[T,4,K] (row 0 = no tolerations)
    tol_idx: np.ndarray  # i32[B]
    # factored policy tables (deduped across the batch)
    aff_masks: np.ndarray  # bool[P,C] unique affinity masks
    aff_idx: np.ndarray  # i32[B] row → mask row
    weight_tables: np.ndarray  # i64[W,C] unique static-weight tables (row 0 = zeros)
    weight_idx: np.ndarray  # i32[B]
    # sparse previous-placement / eviction entries; column index C = padding
    prev_idx: np.ndarray  # i32[B,Kp]
    prev_rep: np.ndarray  # i32[B,Kp]
    evict_idx: np.ndarray  # i32[B,Ke]
    # tie-break randomness: per-binding seed, expanded on device
    seeds: np.ndarray  # u64[B]
    n_clusters: int = 0
    # deduped request vectors: the [.,C,R] estimator divisions run once per
    # DISTINCT request (policies are few); rows gather via req_idx. The
    # dense [B,R] form is the `request` property.
    req_unique: "np.ndarray | None" = None  # i64[U,R]
    req_idx: "np.ndarray | None" = None  # i32[B]

    @property
    def size(self) -> int:
        return len(self.keys)

    # -- dense views (mesh path, oracle parity tests) ---------------------

    @property
    def request(self) -> np.ndarray:  # i64[B,R]
        if self.req_unique is None or self.req_idx is None:
            raise ValueError(
                "BindingBatch.request needs req_unique/req_idx — hand-built "
                "batches must carry the deduped request tables; use "
                "BatchEncoder.encode() to construct batches"
            )
        return self.req_unique[self.req_idx]

    @property
    def tol_key(self) -> np.ndarray:  # i32[B,K]
        return self.tol_tables[self.tol_idx, 0]

    @property
    def tol_value(self) -> np.ndarray:  # i32[B,K]
        return self.tol_tables[self.tol_idx, 1]

    @property
    def tol_effect(self) -> np.ndarray:  # i32[B,K]
        return self.tol_tables[self.tol_idx, 2]

    @property
    def tol_op(self) -> np.ndarray:  # i32[B,K]
        return self.tol_tables[self.tol_idx, 3]

    @property
    def affinity_ok(self) -> np.ndarray:  # bool[B,C]
        return self.aff_masks[self.aff_idx]

    @property
    def static_weight(self) -> np.ndarray:  # i64[B,C]
        return self.weight_tables[self.weight_idx]

    @property
    def prev_member(self) -> np.ndarray:  # bool[B,C]
        out = np.zeros((len(self.replicas), self.n_clusters), bool)
        rows, cols = np.nonzero(self.prev_idx < self.n_clusters)
        out[rows, self.prev_idx[rows, cols]] = True
        return out

    @property
    def prev_replicas(self) -> np.ndarray:  # i32[B,C]
        out = np.zeros((len(self.replicas), self.n_clusters), np.int32)
        rows, cols = np.nonzero(self.prev_idx < self.n_clusters)
        out[rows, self.prev_idx[rows, cols]] = self.prev_rep[rows, cols]
        return out

    @property
    def eviction_ok(self) -> np.ndarray:  # bool[B,C]
        out = np.ones((len(self.replicas), self.n_clusters), bool)
        rows, cols = np.nonzero(self.evict_idx < self.n_clusters)
        out[rows, self.evict_idx[rows, cols]] = False
        return out

    @property
    def tie(self) -> np.ndarray:  # i32[B,C]
        idx = np.arange(1, self.n_clusters + 1, dtype=np.uint64)[None, :]
        return (_mix64(self.seeds[:, None] ^ idx) >> np.uint64(33)).astype(np.int32)


class BatchEncoder:
    """Encodes bindings against one fleet encoding. Create a new instance
    when the fleet changes (affinity masks depend on cluster labels)."""

    def __init__(self, encoder: FleetEncoder, fleet: FleetArrays, clusters, max_tolerations: int = 6):
        self.encoder = encoder
        self.fleet = fleet
        self.clusters = list(clusters)
        self.max_tolerations = max_tolerations
        self.affinity_cache = AffinityMaskCache(self.clusters)
        self._weight_cache: dict[str, np.ndarray] = {}
        self._cluster_index = {c.name: i for i, c in enumerate(self.clusters)}
        self._res_index = {r: i for i, r in enumerate(encoder.resources)}
        # Persistent interners + per-binding row cache. The reference never
        # re-parses an object per schedule attempt — the informer cache hands
        # the scheduler pre-decoded structs; this cache is that decode step.
        # A row is reused only while (generation, term, replicas) match AND
        # the placement/requirements/resource objects are the SAME objects
        # (`is` — the cache holds strong refs, so ids cannot recycle);
        # store-managed updates replace objects and bump generation, which
        # invalidates naturally. prev/eviction entries and `fresh` are
        # re-read every round (status-driven, cheap).
        self._row_cache: dict[str, tuple] = {}
        # per-call identity memos over policy objects (reassigned fresh at
        # every encode() and cleared at its end — stale ids are never read)
        self._call_aff_memo: dict[int, np.ndarray] = {}
        self._call_weight_memo: dict[int, tuple] = {}
        self._tol_width = max_tolerations
        self._tol_rows: list[np.ndarray] = [
            np.zeros((4, self._tol_width), np.int32)
        ]
        # high-water marks for the content-dependent table axes (sparse
        # prev/evict widths, policy-table row counts): each batch pads to
        # the pow2 bucket of the LARGEST value this encoder has seen, not
        # just this batch's. A per-batch bucket makes the program shape a
        # function of batch COMPOSITION — under the streaming scheduler,
        # where micro-batches are arbitrary queue slices, that axis would
        # wobble (e.g. a batch with vs without a 33-target binding flips
        # Kp 32↔64) and each flip is a fresh XLA compile mid-stream. The
        # marks only grow (bounded by pow2(C) / pow2(P)), convergence is
        # one warm pass, pad entries are never indexed ⇒ decisions are
        # bit-identical either way.
        self._kp_hwm = 0
        self._ke_hwm = 1
        self._pp_hwm = 2
        self._wp_hwm = 2
        self._tol_by_key: dict[bytes, int] = {}
        self._tol_stack: Optional[np.ndarray] = None
        self._req_rows: list[np.ndarray] = []
        self._req_by_key: dict[bytes, int] = {}
        self._req_stack: Optional[np.ndarray] = None

    def _static_weights(self, placement: Optional[Placement]) -> np.ndarray:
        """weight[c] = max over matching rules (division_algorithm.go:40-55);
        0 where no rule matches. The all-zero → all-ones fallback happens on
        device against the *candidate* set."""
        C = len(self.clusters)
        if (
            placement is None
            or placement.replica_scheduling is None
            or placement.replica_scheduling.weight_preference is None
            or not placement.replica_scheduling.weight_preference.static_weight_list
        ):
            return np.zeros(C, np.int64)
        rules = placement.replica_scheduling.weight_preference.static_weight_list
        key = "&".join(f"{affinity_key(r.target_cluster)}#{r.weight}" for r in rules)
        w = self._weight_cache.get(key)
        if w is None:
            w = np.zeros(C, np.int64)
            for r in rules:
                m = self.affinity_cache.mask(r.target_cluster)
                w = np.where(m, np.maximum(w, r.weight), w)
            self._weight_cache[key] = w
        return w

    def active_affinity(self, rb: ResourceBinding, term_index: int = -1):
        """Single affinity, or the term_index-th ordered affinity term
        (scheduler.go:562-625 failover loop)."""
        p = rb.spec.placement
        if p is None:
            return None
        if p.cluster_affinities:
            i = max(term_index, 0)
            return p.cluster_affinities[i].affinity
        return p.cluster_affinity

    # growth caps: the interners/row cache trade memory for encode speed;
    # past these bounds (a pathological churn of distinct policy values)
    # everything is dropped and rebuilt from the live rows of the next
    # encode — a one-round re-encode, not a leak
    MAX_REQ_ROWS = 1024
    MAX_TOL_ROWS = 512

    def _reset_interners(self) -> None:
        self._row_cache.clear()  # cached rows hold req/tol ids → must drop
        self._req_rows = []
        self._req_by_key = {}
        self._req_stack = None
        self._tol_width = self.max_tolerations
        self._tol_rows = [np.zeros((4, self._tol_width), np.int32)]
        self._tol_by_key = {}
        self._tol_stack = None

    def _intern_req(self, req: np.ndarray) -> int:
        key = req.tobytes()
        rid = self._req_by_key.get(key)
        if rid is None:
            rid = len(self._req_rows)
            self._req_rows.append(req)
            self._req_by_key[key] = rid
            self._req_stack = None
        return rid

    def _req_table(self) -> np.ndarray:
        """Request table padded to a pow2 bucket (jit cache bound)."""
        if self._req_stack is None:
            Up = pow2_bucket(max(len(self._req_rows), 1), lo=1)
            tab = np.zeros((Up, len(self.encoder.resources)), np.int64)
            if self._req_rows:
                tab[: len(self._req_rows)] = np.stack(self._req_rows)
            self._req_stack = tab
        return self._req_stack

    def _intern_tol(self, tols) -> int:
        if not tols:
            return 0
        if len(tols) > self._tol_width:
            # widen the whole table (capping would wrongly reject bindings
            # whose matching toleration is dropped); ids stay stable
            w = pow2_bucket(len(tols), lo=self._tol_width)
            self._tol_rows = [
                np.pad(r, [(0, 0), (0, w - self._tol_width)])
                for r in self._tol_rows
            ]
            self._tol_width = w
            self._tol_by_key = {
                r.tobytes(): i for i, r in enumerate(self._tol_rows)
            }
            self._tol_stack = None
        trow = np.zeros((4, self._tol_width), np.int32)
        for k, tol in enumerate(tols):
            trow[0, k] = self.encoder.strings.id(tol.key)
            trow[1, k] = self.encoder.strings.id(tol.value)
            trow[2, k] = EFFECT_CODES.get(tol.effect, 0)
            trow[3, k] = (
                TOL_OP_EXISTS if tol.operator == "Exists" else TOL_OP_EQUAL
            )
        key = trow.tobytes()
        tid = self._tol_by_key.get(key)
        if tid is None:
            tid = len(self._tol_rows)
            self._tol_rows.append(trow)
            self._tol_by_key[key] = tid
            self._tol_stack = None
        return tid

    def _tol_table(self) -> np.ndarray:
        """Toleration table with T padded to a pow2 bucket — tol_tables is a
        traced kernel arg, so an unpadded T would recompile the schedule
        kernel every time one new distinct toleration set appears."""
        if self._tol_stack is None:
            T = len(self._tol_rows)
            Tp = pow2_bucket(T, lo=1)
            tab = np.zeros((Tp, 4, self._tol_width), np.int32)
            tab[:T] = np.stack(self._tol_rows)
            self._tol_stack = tab
        return self._tol_stack

    _DEFAULT_PLACEMENT = Placement()

    def _encode_row(self, rb: ResourceBinding, term: int) -> tuple:
        """Everything about a row that does not change while its
        (generation, placement, requirements, resource) stay the same."""
        meta = rb.metadata
        spec = rb.spec
        uid = meta.uid or meta.key()
        req = np.zeros(len(self.encoder.resources), np.int64)
        unknown = False
        if spec.replica_requirements is not None:
            for rname, val in spec.replica_requirements.resource_request.items():
                r = self._res_index.get(rname)
                if r is None:
                    # outside the vocabulary ⇒ estimators must report 0
                    # (missing allocatable key → 0, general.go:166-169)
                    if to_int_units(rname, val) > 0:
                        unknown = True
                else:
                    req[r] = to_int_units(rname, val)
        placement = spec.placement or self._DEFAULT_PLACEMENT
        # per-CALL identity memos (reset at every encode()): thousands of
        # rows share a handful of policy objects, and within one call the
        # objects cannot change — so the canonical-key string builds run
        # once per distinct object, not once per row. Safe against in-place
        # mutation between rounds (the generation-bump contract): the memo
        # never outlives the call.
        aff = self.active_affinity(rb, term)
        mask = self._call_aff_memo.get(id(aff))
        if mask is None:
            mask = self.affinity_cache.mask(aff)
            self._call_aff_memo[id(aff)] = mask
        went = self._call_weight_memo.get(id(placement))
        if went is None:
            w = self._static_weights(placement)
            if not w.any():
                w = None  # row 0 of the weight table
            self._call_weight_memo[id(placement)] = (w,)
        else:
            (w,) = went
        return (
            meta.key(),
            uid,
            uid_seed(uid),
            self.encoder.gvk_id(spec.resource.api_version, spec.resource.kind),
            strategy_code(spec.placement, spec.replicas),
            unknown,
            self._intern_req(req),
            self._intern_tol(placement.cluster_tolerations),
            mask,
            w,
        )

    def encode(
        self,
        bindings: Sequence[ResourceBinding],
        term_indices: Optional[Sequence[int]] = None,
    ) -> BindingBatch:
        B = len(bindings)
        C = len(self.clusters)

        keys, uids = [], []
        replicas = np.zeros(B, np.int32)
        unknown_request = np.zeros(B, bool)
        gvk = np.zeros(B, np.int32)
        strategy = np.zeros(B, np.int32)
        fresh = np.zeros(B, bool)
        tol_idx = np.zeros(B, np.int32)
        req_idx_arr = np.zeros(B, np.int32)
        seeds = np.zeros(B, np.uint64)

        # factored tables: dedup masks/weights per policy signature (few
        # distinct policies, many bindings); indices per row
        aff_rows: list[np.ndarray] = []
        aff_by_id: dict[int, int] = {}  # id(mask buffer) → table row
        aff_idx = np.zeros(B, np.int32)
        weight_rows: list[np.ndarray] = [np.zeros(C, np.int64)]  # row 0 = zeros
        weight_by_id: dict[int, int] = {}
        weight_idx = np.zeros(B, np.int32)

        prev_lists: list = []
        evict_lists: list = []

        # bound the caches: entries for deleted bindings (and pathological
        # churn of distinct request/toleration values) must not accumulate
        # forever — reset costs one round of re-encode
        if (
            len(self._req_rows) > self.MAX_REQ_ROWS
            or len(self._tol_rows) > self.MAX_TOL_ROWS
        ):
            self._reset_interners()
        elif len(self._row_cache) > max(4 * B, 16384):
            self._row_cache.clear()

        row_cache = self._row_cache
        # fresh per-call memos; id(None) maps the no-affinity case safely
        # (None is immortal and its mask is constant). Cleared again at the
        # end of the call so entries never outlive it.
        self._call_aff_memo = {}
        self._call_weight_memo = {}
        for b, rb in enumerate(bindings):
            meta = rb.metadata
            spec = rb.spec
            term = -1 if term_indices is None else term_indices[b]
            ent = row_cache.get(meta.uid) if meta.uid else None
            if (
                ent is not None
                and ent[0] == meta.generation
                and ent[1] == term
                and ent[2] == spec.replicas
                # strong refs held below ⇒ `is` cannot false-positive on a
                # recycled id; store updates swap objects + bump generation
                and ent[3] is spec.placement
                and ent[4] is spec.replica_requirements
                and ent[5] is spec.resource
            ):
                data = ent[6]
            else:
                data = self._encode_row(rb, term)
                if meta.uid:
                    row_cache[meta.uid] = (
                        meta.generation, term, spec.replicas,
                        spec.placement, spec.replica_requirements,
                        spec.resource, data,
                    )
            key, uid, seed, g, strat, unknown, rid, tid, mask, w = data
            keys.append(key)
            uids.append(uid)
            seeds[b] = seed
            gvk[b] = g
            strategy[b] = strat
            unknown_request[b] = unknown
            req_idx_arr[b] = rid
            tol_idx[b] = tid
            replicas[b] = spec.replicas
            fresh[b] = _reschedule_required(spec, rb.status)

            row = aff_by_id.get(id(mask))
            if row is None:
                row = len(aff_rows)
                aff_rows.append(mask)
                aff_by_id[id(mask)] = row
            aff_idx[b] = row
            if w is None:
                wrow = 0
            else:
                wrow = weight_by_id.get(id(w))
                if wrow is None:
                    wrow = len(weight_rows)
                    weight_rows.append(w)
                    weight_by_id[id(w)] = wrow
            weight_idx[b] = wrow

            # previous placement / eviction entries are status-driven per
            # round — never cached
            prev_lists.append(
                [
                    (i, tc.replicas)
                    for tc in spec.clusters
                    if (i := self._cluster_index.get(tc.name)) is not None
                ]
                if spec.clusters
                else ()
            )
            evict_lists.append(
                [
                    i
                    for task in spec.graceful_eviction_tasks
                    if (i := self._cluster_index.get(task.from_cluster)) is not None
                ]
                if spec.graceful_eviction_tasks
                else ()
            )

        # sparse axes bucketed to powers of two (jit cache bound), floored
        # at the encoder's high-water mark so batch composition cannot
        # shrink (and later re-grow ⇒ recompile) the shape
        self._kp_hwm = Kp = max(
            pow2_bucket(max(map(len, prev_lists), default=0)), self._kp_hwm
        )
        self._ke_hwm = Ke = max(
            pow2_bucket(max(map(len, evict_lists), default=0), lo=1),
            self._ke_hwm,
        )
        prev_idx = np.full((B, Kp), C, np.int32)  # C = drop sentinel
        prev_rep = np.zeros((B, Kp), np.int32)
        evict_idx = np.full((B, Ke), C, np.int32)
        for b in range(B):
            for k, (i, rep) in enumerate(prev_lists[b]):
                prev_idx[b, k] = i
                prev_rep[b, k] = rep
            for k, i in enumerate(evict_lists[b]):
                evict_idx[b, k] = i

        self._call_aff_memo = {}
        self._call_weight_memo = {}
        # policy-table row axes pad to pow2 buckets (lo=2 so the ubiquitous
        # one-policy and two-policy rounds share a shape): aff_masks and
        # weight_tables are traced kernel args, and an unpadded P/W would
        # recompile the round whenever the BATCH COMPOSITION changes — the
        # exact churn the shape-bucket lattice exists to absorb. Pad rows
        # are never indexed (aff_idx/weight_idx point at real rows only).
        aff = np.stack(aff_rows) if aff_rows else np.ones((1, C), bool)
        self._pp_hwm = Pp = max(pow2_bucket(len(aff), lo=2), self._pp_hwm)
        if Pp > len(aff):
            aff = np.pad(aff, [(0, Pp - len(aff)), (0, 0)])
        wt = np.stack(weight_rows)
        self._wp_hwm = Wp = max(pow2_bucket(len(wt), lo=2), self._wp_hwm)
        if Wp > len(wt):
            wt = np.pad(wt, [(0, Wp - len(wt)), (0, 0)])
        return BindingBatch(
            keys=keys,
            uids=uids,
            replicas=replicas,
            unknown_request=unknown_request,
            gvk=gvk,
            strategy=strategy,
            fresh=fresh,
            tol_tables=self._tol_table(),
            tol_idx=tol_idx,
            aff_masks=aff,
            aff_idx=aff_idx,
            weight_tables=wt,
            weight_idx=weight_idx,
            prev_idx=prev_idx,
            prev_rep=prev_rep,
            evict_idx=evict_idx,
            seeds=seeds,
            n_clusters=C,
            req_unique=self._req_table(),
            req_idx=req_idx_arr,
        )


def _reschedule_required(spec, status) -> bool:
    """util.RescheduleRequired: a WorkloadRebalancer stamped
    spec.rescheduleTriggeredAt after the last successful schedule
    (assignment.go:110-115 → Fresh mode)."""
    if spec.reschedule_triggered_at is None:
        return False
    if status.last_scheduled_time is None:
        return True
    return spec.reschedule_triggered_at > status.last_scheduled_time
