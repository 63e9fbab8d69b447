"""Observability: local utiltrace spans and the distributed placement-
tracing plane (the port's copy of the JAX package's tracing/, the parts
the scheduler daemon uses).

- `Trace` (tracing/utiltrace.py) — k8s.io/utils/trace-style local spans
  logged only when slow (ref estimate.go:37-38);
- `tracer` / `Span` (tracing/spans.py) — per-binding causal traces from
  admission to the store patch, head sampling + forced tail sampling of
  SLO breaches, `X-Karmada-Trace` context propagation;
- `slo_report()` — the per-stage p50/p99 attribution table.

The trace collector, the waterfall renderer and the profile endpoints
(`collect.py`, `render.py`, `profile.py`) are not ported yet.
"""
from .spans import (
    APPLY_SPAN_ANNOTATION,
    TRACE_HEADER,
    PlacementTracer,
    Span,
    current_context,
    format_trace_header,
    new_span_id,
    parse_trace_header,
    slo_report,
    trace_context,
    tracer,
)
from .utiltrace import DEFAULT_SLOW_THRESHOLD_S, Trace, logger

__all__ = [
    "APPLY_SPAN_ANNOTATION",
    "DEFAULT_SLOW_THRESHOLD_S",
    "PlacementTracer",
    "Span",
    "TRACE_HEADER",
    "Trace",
    "current_context",
    "format_trace_header",
    "logger",
    "new_span_id",
    "parse_trace_header",
    "slo_report",
    "trace_context",
    "tracer",
]
