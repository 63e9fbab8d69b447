"""What-if simulation plane: scenario-batched counterfactual solves.

See engine.py for the scenario-stacked [S,B,C] solve, report.py for the
SimulationReport, preflight.py for the FederatedResourceQuota
admission preflight.
"""
from .engine import (  # noqa: F401
    ScenarioOutcome,
    Simulator,
    apply_scenario_objects,
    scenario_steps,
    surge_bindings,
)
from .report import build_report, diff_placements, fingerprint  # noqa: F401
