"""Self-describing JSON codec for store objects crossing the serving seam
(the port's copy of server/codec.py).

The store holds two object shapes: typed dataclasses (`karmada_tpu_torch.
api.*`, recorded Events) and `Unstructured` manifests. On the wire each
dataclass is tagged with `__t: "<module_tail>.<ClassName>"` so the
receiving side reconstructs the exact type without a schema exchange. The
tag carries the module's last component only, so a port object and its
JAX-package twin (same module tail, same fields in the same order) encode
to the same bytes, and either package decodes the other's.

Decode is forward-compatible: unknown fields are dropped, missing fields
take dataclass defaults. A tag the port knows but has not ported yet (the
agent's heartbeat `Lease`, `MemberConfig`, the api modules the control
plane brings) raises a TypeError naming its queue item instead of decoding
to something else.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any

from ..api.unstructured import Unstructured

_TAG = "__t"
_UNSTRUCTURED_TAG = "unstructured.Unstructured"

_registry: dict[str, type] = {}
_by_class: dict[type, str] = {}
# per class: its field names in order, and the names __init__ takes
# (dataclasses.fields() walks the class on every call; the wire walks
# every node of every object)
_field_names: dict[type, tuple[str, ...]] = {}
_init_names: dict[type, frozenset] = {}

# wire tags of the reference's object model that the port has no type for
# yet: exact tags, then whole module tails, each with its ROADMAP queue A item
_UNPORTED_TAGS = {
    "agent.Lease": 12, "member.MemberConfig": 12,
    **{f"search.{name}": 12 for name in (
        "BackendStoreConfig", "ClusterObjectSummary", "ObjectSummaryRow",
        "ResourceRegistry", "ResourceRegistrySpec", "SearchResourceSelector",
    )},
}
_UNPORTED_MODULES = {
    "apps": 12, "autoscaling": 12, "interpreter": 12, "networking": 12,
    "remedy": 12,
}


def _tag_for(cls: type) -> str:
    return f"{cls.__module__.rsplit('.', 1)[-1]}.{cls.__qualname__}"


def register_type(cls: type) -> type:
    """Add a dataclass to the wire registry (idempotent)."""
    tag = _tag_for(cls)
    existing = _registry.get(tag)
    if existing is not None and existing is not cls:
        raise TypeError(f"codec tag collision: {tag} -> {existing} and {cls}")
    _registry[tag] = cls
    _by_class[cls] = tag
    return cls


def _scan() -> None:
    """Register every dataclass in karmada_tpu_torch.api plus the non-api
    kinds that live in the store or cross the seam (recorded Events,
    estimator NodeSpecs)."""
    import karmada_tpu_torch.api as api_pkg

    for info in pkgutil.iter_modules(api_pkg.__path__):
        mod = importlib.import_module(f"karmada_tpu_torch.api.{info.name}")
        for v in vars(mod).values():
            if isinstance(v, type) and dataclasses.is_dataclass(v) \
                    and v.__module__ == mod.__name__:
                register_type(v)
    from ..events import Event
    from ..models.nodes import NodeSpec

    register_type(Event)
    register_type(NodeSpec)


_scan()


def _unknown(tag: str) -> TypeError:
    item = _UNPORTED_TAGS.get(tag)
    if item is None:
        item = _UNPORTED_MODULES.get(tag.split(".", 1)[0])
    if item is not None:
        return TypeError(f"wire type {tag!r} is not ported yet "
                         f"(ROADMAP queue A item {item})")
    return TypeError(f"unknown wire type {tag!r}")


def encode(value: Any) -> Any:
    """→ JSON-safe structure; inverse of decode()."""
    if isinstance(value, Unstructured):
        return {_TAG: _UNSTRUCTURED_TAG, "manifest": value.to_dict()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        tag = _by_class.get(type(value))
        if tag is None:
            tag = _by_class[register_type(type(value))]
        names = _field_names.get(type(value))
        if names is None:
            names = _field_names[type(value)] = tuple(
                f.name for f in dataclasses.fields(value))
        out: dict[str, Any] = {_TAG: tag}
        for name in names:
            out[name] = encode(getattr(value, name))
        return out
    if isinstance(value, dict):
        return {k: encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode(v) for v in value]
    return value


def decode(value: Any) -> Any:
    if isinstance(value, dict):
        tag = value.get(_TAG)
        if tag == _UNSTRUCTURED_TAG:
            return Unstructured(value.get("manifest") or {})
        if tag is not None:
            cls = _registry.get(tag)
            if cls is None:
                raise _unknown(tag)
            names = _init_names.get(cls)
            if names is None:
                names = _init_names[cls] = frozenset(
                    f.name for f in dataclasses.fields(cls) if f.init)
            kwargs = {
                k: decode(v) for k, v in value.items()
                if k != _TAG and k in names
            }
            return cls(**kwargs)
        return {k: decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode(v) for v in value]
    return value
