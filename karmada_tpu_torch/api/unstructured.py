"""Unstructured workload objects (templates) stored as plain dict manifests.

The port's copy of the JAX package's `api/unstructured.py`, unchanged in behaviour.

The reference detector watches *all* API resources as
unstructured.Unstructured (pkg/detector/detector.go:112); we mirror that with
a thin wrapper over a dict manifest that exposes ObjectMeta accessors so it can
live in the same store as typed objects.
"""
from __future__ import annotations

import copy
from typing import Any, Optional

from .meta import ObjectMeta


def copy_json_tree(x: Any) -> Any:
    """Deep-copy a JSON-shaped tree several times faster than copy.deepcopy
    (no memo bookkeeping, no reduce protocol) — manifests are copied on
    every store write, so this is control-plane write-path time. Non-JSON
    leaves (rare: objects placed via set()) fall back to copy.deepcopy for
    fidelity. Aliased sub-trees are duplicated rather than shared, which
    only strengthens isolation for store semantics; cycles are the
    caller's bug (json.dumps would reject the manifest anyway)."""
    t = x.__class__
    if t is dict:
        return {k: copy_json_tree(v) for k, v in x.items()}
    if t is list:
        return [copy_json_tree(v) for v in x]
    if t is str or t is int or t is float or t is bool or x is None:
        return x
    return copy.deepcopy(x)


class Unstructured:
    """Dict-backed object: {'apiVersion','kind','metadata',...}."""

    def __init__(self, manifest: dict):
        manifest.setdefault("metadata", {})
        self._m = manifest
        self._load_meta()

    def _load_meta(self) -> None:
        """(Re)build the typed metadata view from the backing dict."""
        md = self._m["metadata"]
        self.metadata = ObjectMeta(
            name=md.get("name", ""),
            namespace=md.get("namespace", ""),
            uid=md.get("uid", ""),
            labels=md.setdefault("labels", {}),
            annotations=md.setdefault("annotations", {}),
            finalizers=md.setdefault("finalizers", []),
            resource_version=md.get("resourceVersion", 0),
            generation=md.get("generation", 0),
            creation_timestamp=md.get("creationTimestamp", 0.0),
            deletion_timestamp=md.get("deletionTimestamp"),
        )

    # Keep the wrapper and the dict view coherent when the store mutates meta.
    def sync_meta(self) -> None:
        md = self._m["metadata"]
        md["name"] = self.metadata.name
        md["namespace"] = self.metadata.namespace
        md["uid"] = self.metadata.uid
        md["labels"] = self.metadata.labels
        md["annotations"] = self.metadata.annotations
        md["finalizers"] = self.metadata.finalizers
        md["resourceVersion"] = self.metadata.resource_version
        md["generation"] = self.metadata.generation
        md["creationTimestamp"] = self.metadata.creation_timestamp
        if self.metadata.deletion_timestamp is not None:
            md["deletionTimestamp"] = self.metadata.deletion_timestamp

    @property
    def kind(self) -> str:
        return self._m.get("kind", "")

    @property
    def api_version(self) -> str:
        return self._m.get("apiVersion", "")

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def to_dict(self) -> dict:
        self.sync_meta()
        return copy_json_tree(self._m)

    def spec_view(self) -> dict:
        """The manifest minus status/metadata WITHOUT copying — the store's
        generation-diff compares two of these for equality only. Read-only:
        the values alias the live manifest; callers must not mutate or
        retain them. (to_dict() here deepcopied the whole manifest twice
        per update, inside the store's critical section.)"""
        return {
            k: v for k, v in self._m.items()
            if k not in ("status", "metadata")
        }

    def merge_patch(self, patch: dict) -> None:
        """RFC 7386 merge-patch applied in place: null deletes, dicts
        recurse (kubectl patch --type=merge semantics)."""

        def merge(dst: dict, src: dict) -> None:
            for k, v in src.items():
                if v is None:
                    dst.pop(k, None)
                elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v

        merge(self._m, patch)
        self._m.setdefault("metadata", {})
        # re-derive the typed view: without this, sync_meta would write the
        # PRE-patch metadata back over any metadata fields the patch touched
        self._load_meta()

    def get(self, *path: str, default: Any = None) -> Any:
        cur: Any = self._m
        for p in path:
            if not isinstance(cur, dict) or p not in cur:
                return default
            cur = cur[p]
        return cur

    def set(self, *path_and_value: Any) -> None:
        *path, value = path_and_value
        cur = self._m
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = value

    @property
    def spec(self) -> dict:
        return self._m.setdefault("spec", {})

    @property
    def status(self) -> dict:
        return self._m.setdefault("status", {})

    @status.setter
    def status(self, v: dict) -> None:
        self._m["status"] = v

    def __deepcopy__(self, memo):
        self.sync_meta()
        return Unstructured(copy_json_tree(self._m))

    def __repr__(self) -> str:
        return f"Unstructured({self.api_version}/{self.kind} {self.metadata.key()})"
