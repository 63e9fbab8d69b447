"""The SimulationReport: turn ScenarioOutcomes into the API resource
(the port's copy of the JAX package's simulation/report.py).

Displacement is measured against the BASELINE counterfactual solve (what the
scheduler would place on the unperturbed fleet right now), not against the
possibly-stale spec.clusters — except where a caller (the descheduler's
dry-run) explicitly supplies the current assignments as the before-image.
"""
from __future__ import annotations

from typing import Optional

from ..api.meta import ObjectMeta
from ..api.simulation import (
    BindingDiff,
    ScenarioReport,
    SimulationReport,
    SimulationRequest,
)
from .engine import ScenarioOutcome


def fingerprint(targets) -> tuple:
    return tuple(sorted((t.name, t.replicas) for t in (targets or [])))


def diff_placements(
    before_placements: dict, before_errors: dict, out: ScenarioOutcome,
    limit: int = 8,
) -> ScenarioReport:
    """One scenario's report row: every binding whose placement changed
    (including ok→unplaceable transitions and rows that exist only under
    the scenario, e.g. surge rows) counts as displaced; the first `limit`
    diffs are carried verbatim."""
    displaced = 0
    diffs: list[BindingDiff] = []

    def note(key, before, after, error=""):
        nonlocal displaced
        displaced += 1
        if len(diffs) < limit:
            diffs.append(BindingDiff(
                binding=key, before=list(before or []),
                after=list(after or []), error=error,
            ))

    seen = set()
    for key, after in out.placements.items():
        seen.add(key)
        before = before_placements.get(key)
        if key in before_errors or (
            fingerprint(before) != fingerprint(after)
        ):
            note(key, before, after)
    for key, err in out.errors.items():
        seen.add(key)
        if key not in before_errors:
            note(key, before_placements.get(key), None, error=err)
    # rows that vanished from the scenario entirely (baseline-only surge
    # rows cannot occur — surge rows belong to their scenario — but a
    # caller-supplied before-image may cover more rows than the outcome)
    return ScenarioReport(
        scenario=out.scenario,
        displaced=displaced,
        unplaceable=len(out.errors),
        injected=out.injected,
        overcommitted=list(out.overcommitted),
        diffs=diffs,
    )


def build_report(
    request: Optional[SimulationRequest],
    baseline: ScenarioOutcome,
    outcomes: list[ScenarioOutcome],
    stats: Optional[dict] = None,
    name: str = "",
    clusters: int = 0,
    bindings: int = 0,
) -> SimulationReport:
    limit = request.spec.diff_limit if request is not None else 8
    report = SimulationReport(
        metadata=ObjectMeta(name=name or (
            request.metadata.name if request is not None else ""
        )),
        scenarios=[
            diff_placements(baseline.placements, baseline.errors, o, limit)
            for o in outcomes
        ],
        bindings=bindings,
        clusters=clusters,
        baseline_unplaceable=baseline.unplaceable,
        batched_solves=(stats or {}).get("batched_solves", 0),
        fallback_solves=(stats or {}).get("fallback_solves", 0),
    )
    return report
