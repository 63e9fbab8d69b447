"""Admission framework (the port's copy of the JAX package's
webhook/admission.py; reference: pkg/webhook/, the mutating/validating
admission.Handler packages registered on the apiserver admission path).

Every create/update/delete runs the chain — matching mutating webhooks
first (in registration order), then validating webhooks; a validating
webhook denies by raising AdmissionDenied, which surfaces to the caller
exactly like an apiserver 403/422.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"


class AdmissionDenied(Exception):
    def __init__(self, webhook: str, reason: str):
        super().__init__(f"admission webhook {webhook!r} denied the request: {reason}")
        self.webhook = webhook
        self.reason = reason


@dataclass
class AdmissionRequest:
    operation: str  # CREATE | UPDATE | DELETE
    kind: str
    obj: Any
    old_thunk: Optional[Callable[[], Any]] = None  # lazy: most webhooks never read old
    _old: Any = None
    _old_resolved: bool = False

    @property
    def old_obj(self) -> Any:
        if not self._old_resolved:
            self._old = self.old_thunk() if self.old_thunk is not None else None
            self._old_resolved = True
        return self._old


@dataclass
class Webhook:
    """One admission registration. `kinds` matches the store kind key;
    mutate returns the (possibly modified) object; validate raises to deny."""

    name: str
    kinds: tuple[str, ...]
    mutate: Optional[Callable[[AdmissionRequest], Any]] = None
    validate: Optional[Callable[[AdmissionRequest], None]] = None

    def matches(self, kind: str) -> bool:
        return "*" in self.kinds or kind in self.kinds


class AdmissionChain:
    def __init__(self) -> None:
        self.webhooks: list[Webhook] = []

    def register(self, webhook: Webhook) -> None:
        self.webhooks.append(webhook)

    def admit(
        self, operation: str, kind: str, obj: Any, old_thunk: Optional[Callable[[], Any]] = None
    ) -> Any:
        req = AdmissionRequest(operation=operation, kind=kind, obj=obj, old_thunk=old_thunk)
        if operation != DELETE:
            for wh in self.webhooks:
                if wh.mutate is not None and wh.matches(kind):
                    out = wh.mutate(req)
                    if out is not None:
                        req.obj = out
        for wh in self.webhooks:
            if wh.validate is not None and wh.matches(kind):
                wh.validate(req)
        return req.obj
