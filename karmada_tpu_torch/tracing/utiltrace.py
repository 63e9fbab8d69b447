"""utiltrace-style local spans with slow-path logging.

The port's copy of the JAX package's `tracing/utiltrace.py`, unchanged in behaviour.

Parity with the reference's k8s.io/utils/trace usage: named spans with
fields and nested steps, logged ONLY when the total duration crosses a
threshold (ref pkg/estimator/server/estimate.go:37-38 logs estimates slower
than 100 ms with per-step timing). This is the PROCESS-LOCAL aid; the
fleet-wide causal layer lives in tracing/spans.py (docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger("karmada_tpu_torch.trace")

DEFAULT_SLOW_THRESHOLD_S = 0.100  # estimate.go:38


@dataclass
class _Step:
    msg: str
    at: float


@dataclass
class Trace:
    """utiltrace.Trace: step() marks checkpoints; log_if_long() emits the
    whole span breakdown when the total exceeds the threshold."""

    name: str
    fields: dict = field(default_factory=dict)
    clock: Callable[[], float] = time.perf_counter
    sink: Optional[Callable[[str], None]] = None  # default: logger.warning

    def __post_init__(self):
        self.start = self.clock()
        self.steps: list[_Step] = []

    def step(self, msg: str) -> None:
        self.steps.append(_Step(msg, self.clock()))

    def duration(self) -> float:
        return self.clock() - self.start

    def log_if_long(self, threshold_s: float = DEFAULT_SLOW_THRESHOLD_S) -> bool:
        """Emit the span if it ran long; returns whether it was emitted."""
        total = self.duration()
        if total < threshold_s:
            return False
        parts = [f'"{self.name}"']
        if self.fields:
            parts.append(
                " ".join(f"{k}={v}" for k, v in self.fields.items())
            )
        parts.append(f"total={total * 1e3:.1f}ms:")
        prev = self.start
        for s in self.steps:
            parts.append(f"[{(s.at - prev) * 1e3:.1f}ms] {s.msg};")
            prev = s.at
        tail = total - (prev - self.start)
        if self.steps and tail > 0:
            parts.append(f"[{tail * 1e3:.1f}ms] (rest)")
        line = "Trace " + " ".join(parts)
        (self.sink or logger.warning)(line)
        return True
