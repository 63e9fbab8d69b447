"""Runtime lock-order watchdog: the dynamic half of the analysis plane.

The port's copy of the JAX package's `analysis/lockorder.py`, unchanged in behaviour.

The static lock-discipline rule keeps foreign work out of the store's
critical section, but an ABBA deadlock needs ORDER information the AST
does not carry. This module records the global lock-acquisition-order
graph while the test suite drives the real multi-lock paths (batch write
+ watch fan-out + coalescer flush concurrently) and fails on cycles.

Opt-in and zero-cost when off: `make_lock(name)` returns a plain
`threading.Lock`/`RLock` unless `KARMADA_TPU_LOCKCHECK=1` is set at
construction time, in which case it returns a `CheckedLock` wrapper that
feeds the process-global `watchdog`. The store, watch-cache, and
write-coalescer locks are constructed through this seam; a dedicated
tier-1 test (tests/test_analysis.py) runs the concurrent store paths
under the gate and asserts the acquisition graph is acyclic.

Edges are per lock NAME (one per lock site, lockdep-style): every Store
instance's lock is "store._lock" — an inversion between two instances of
the same classes is the same bug as between one pair.

`CheckedLock` forwards `_is_owned`/`_release_save`/`_acquire_restore`
so it composes with `threading.Condition` (the watch cache and the
coalescer wrap theirs in conditions) and with `Store._write_lock`'s
re-entrancy probe.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

ENV_GATE = "KARMADA_TPU_LOCKCHECK"


def enabled() -> bool:
    return os.environ.get(ENV_GATE, "") == "1"


@dataclass
class LockOrderViolation:
    """One recorded cycle in the acquisition-order graph."""

    cycle: list[str]                  # lock names, cycle[0] == cycle[-1]
    thread: str                       # thread that closed the cycle
    held: list[str]                   # what it held at the time

    def render(self) -> str:
        return (f"lock-order cycle {' -> '.join(self.cycle)} closed by "
                f"thread {self.thread!r} while holding {self.held}")


class LockOrderWatchdog:
    """Process-global acquisition-order graph. Thread-safe; the graph
    mutex is only ever taken while NO instrumented lock logic runs inside
    it (pure dict/set work), so the watchdog cannot itself deadlock the
    code it watches."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._local = threading.local()
        # edge A -> B: "B was acquired while A was held", with a witness
        self.edges: dict[tuple[str, str], str] = {}
        self.violations: list[LockOrderViolation] = []

    # -- per-thread held stack --------------------------------------------

    def _stack(self) -> list[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    # -- graph ------------------------------------------------------------

    def _path_exists(self, src: str, dst: str) -> Optional[list[str]]:
        """DFS src -> dst over recorded edges; returns the node path."""
        stack = [(src, [src])]
        seen = {src}
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def acquired(self, name: str) -> None:
        """Record that the current thread now holds `name`; called AFTER
        the real acquire succeeded (never blocks the acquire itself)."""
        st = self._stack()
        held = [h for h in st if h != name]
        if held:
            tname = threading.current_thread().name
            with self._mu:
                for h in set(held):
                    if (h, name) not in self.edges:
                        self.edges[(h, name)] = tname
                        # does the REVERSE order already exist? then the
                        # new edge closes a cycle: name ->* h -> name
                        back = self._path_exists(name, h)
                        if back is not None:
                            self.violations.append(LockOrderViolation(
                                cycle=back + [name], thread=tname,
                                held=list(st)))
        st.append(name)

    def released(self, name: str) -> None:
        st = self._stack()
        # release the innermost hold of `name` (re-entrant locks release
        # in LIFO order; Condition.wait releases mid-stack legitimately)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break

    # -- assertions / lifecycle -------------------------------------------

    def assert_acyclic(self) -> None:
        with self._mu:
            if self.violations:
                raise AssertionError(
                    "lock-order watchdog recorded cycle(s):\n  "
                    + "\n  ".join(v.render() for v in self.violations))

    def edge_list(self) -> list[tuple[str, str]]:
        with self._mu:
            return sorted(self.edges)

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.violations.clear()


watchdog = LockOrderWatchdog()


class CheckedLock:
    """Instrumented lock wrapper feeding the watchdog. Wraps an RLock by
    default (the store lock is re-entrant); a same-name re-acquire never
    records a self-edge. Forwards the private hooks `threading.Condition`
    and `Store._write_lock` rely on."""

    def __init__(self, name: str, *, rlock: bool = True,
                 wd: Optional[LockOrderWatchdog] = None) -> None:
        self.name = name
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._wd = wd or watchdog

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._wd.acquired(self.name)
        return ok

    def release(self) -> None:
        self._wd.released(self.name)
        self._inner.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition integration: wait() fully releases a re-entrant
    # hold via _release_save and restores it via _acquire_restore — the
    # watchdog must see those as release/acquire or the held stack skews
    def _release_save(self):
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            save = inner()
        else:
            self._inner.release()
            save = None
        self._wd.released(self.name)
        return save

    def _acquire_restore(self, state) -> None:
        inner = getattr(self._inner, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._inner.acquire()
        self._wd.acquired(self.name)

    def _is_owned(self) -> bool:
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return inner()
        # plain-Lock fallback (threading.Condition's own emulation)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def make_lock(name: str, *, rlock: bool = True):
    """The construction seam: a CheckedLock when KARMADA_TPU_LOCKCHECK=1
    (read at construction — set the env before building the plane), else
    the plain stdlib lock with zero wrapper overhead."""
    if enabled():
        return CheckedLock(name, rlock=rlock)
    return threading.RLock() if rlock else threading.Lock()
