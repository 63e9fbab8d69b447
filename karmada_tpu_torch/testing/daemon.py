"""Spawn daemons as subprocesses and scrape their output lines (the port's
copy of testing/daemon.py) — shared by the process-boundary tests and
chip_smoke.py's wire cells.

Beyond the reference's helpers: `spawn_process(env=)` passes an
environment, the process keeps its output reader (`wait_for_line` reads
lines printed after the startup match, `output_lines` everything read so
far, `line_time` when a line arrived), and `spawn_scheduler` starts
`python -m karmada_tpu_torch.sched`, and `MiniPlane` is the stub plane a
`ControlPlaneServer` serves it from.
`spawn_daemon` starts the control-plane daemon, which waits for the
`ControlPlane` (ROADMAP queue A item 12)."""
from __future__ import annotations

import contextlib
import queue
import re
import subprocess
import sys
import threading
import time
from typing import Optional

from ..coordination.lease import LeaseCoordinator
from ..runtime.controller import Clock
from ..store.store import Store


class MiniPlane:
    """What `ControlPlaneServer` serves without a `ControlPlane` (the
    reference tests' `MiniPlane` and `_StubCP`): a store, a lease
    coordinator over a clock, no members, a no-op `settle` and a `tick`
    that only moves the clock. `clock` defaults to the wall clock (leases
    expire in real time); a `Clock(fixed=...)` makes them step with
    `tick`. `store` and `coordinator` (a class called with the store and
    the clock, or None for a plane without leases) are injectable, so one
    plane holds either package's store and coordinator, or a recording
    coordinator."""

    def __init__(self, clock=None, *, store=None, coordinator=LeaseCoordinator):
        self.store = Store() if store is None else store
        self.clock = Clock() if clock is None else clock
        self.coordinator = (None if coordinator is None
                            else coordinator(self.store, self.clock))
        self.members: dict = {}

    def settle(self, max_steps: int = 0) -> int:
        return 0

    def tick(self, seconds: float = 0.0) -> int:
        if seconds:
            self.clock.advance(seconds)
        return 0


@contextlib.contextmanager
def reaping(*procs):
    """Terminate-and-wait registered processes on exit (last spawned first),
    escalating to kill on a stuck wait; every process is reaped even if an
    earlier teardown raises. Yields a register function for processes
    spawned inside the block."""
    bag = list(procs)
    try:
        yield bag.append
    finally:
        errors = []
        for proc in reversed(bag):
            if proc is None:
                continue
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=15)
            except Exception as e:  # noqa: BLE001 - reap the rest first
                errors.append(e)
        if errors:
            raise errors[0]


def spawn_process(argv: list[str], pattern: str, timeout: float = 60.0,
                  label: str = "daemon", env: Optional[dict] = None):
    """Start argv and read its merged stdout/stderr until `pattern` matches
    a line; returns (proc, match). The deadline is enforced even while no
    output arrives (reader thread + polling get), and process death or
    stdout EOF raises with the captured tail instead of hanging. The
    reader stays attached: `wait_for_line(proc, ...)` goes on from the
    match."""
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env,
    )
    rx = re.compile(pattern)
    # bounded (thread-hygiene): a chatty child blocks its own stdout pipe
    # behind the reader instead of ballooning the test process
    q: queue.Queue = queue.Queue(maxsize=100_000)

    stamps: list = []  # (monotonic arrival time, line), in output order

    def reader() -> None:
        for line in proc.stdout:
            stamps.append((time.monotonic(), line))
            q.put(line)
        q.put(None)

    threading.Thread(target=reader, daemon=True,
                     name=f"spawn-reader-{label}").start()
    lines: list[str] = []
    proc._spawn_queue = q
    proc._spawn_lines = lines
    proc._spawn_label = label
    proc._spawn_stamps = stamps

    def fail(reason: str) -> AssertionError:
        proc.kill()
        return AssertionError(
            f"{label} {reason} (waiting for {pattern!r}):\n"
            + "".join(lines[-10:])
        )

    def drain() -> "re.Match | None":
        """Move everything already buffered into `lines`, scanning for the
        pattern — the child may have printed the match (or its dying
        traceback) moments before exit was observed."""
        while True:
            try:
                line = q.get(timeout=0.5)
            except queue.Empty:
                return None
            if line is None:
                return None
            lines.append(line)
            m = rx.search(line)
            if m:
                return m

    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            m = drain()
            if m:
                return proc, m
            raise fail(f"never matched within {timeout}s")
        try:
            line = q.get(timeout=min(remaining, 0.5))
        except queue.Empty:
            if proc.poll() is not None:
                m = drain()
                if m:
                    return proc, m
                raise fail(f"exited rc={proc.returncode}")
            continue
        if line is None:
            # stdout EOF: collect the exit code (or keep waiting if the
            # child closed its stream while alive)
            if proc.poll() is not None:
                raise fail(f"exited rc={proc.returncode}")
            continue
        lines.append(line)
        m = rx.search(line)
        if m:
            return proc, m


def output_lines(proc) -> list[str]:
    """Every line read from a spawned process so far (drains the reader's
    buffer without waiting)."""
    q = proc._spawn_queue
    while True:
        try:
            line = q.get_nowait()
        except queue.Empty:
            return proc._spawn_lines
        if line is None:
            q.put(None)  # keep EOF visible to later readers
            return proc._spawn_lines
        proc._spawn_lines.append(line)


def wait_for_line(proc, pattern: str, timeout: float = 60.0,
                  start: int = 0) -> "re.Match":
    """Wait until a line at index >= `start` of the process's output
    matches `pattern` (lines already read count too); raises with the
    output's tail on timeout or EOF. `start` lets a caller skip the lines
    it has already seen (`len(output_lines(proc))`)."""
    rx = re.compile(pattern)
    lines = proc._spawn_lines
    seen = start
    deadline = time.monotonic() + timeout
    while True:
        for i in range(seen, len(lines)):
            m = rx.search(lines[i])
            if m:
                return m
        seen = max(seen, len(lines))
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise AssertionError(
                f"{proc._spawn_label} never printed {pattern!r} within "
                f"{timeout}s:\n" + "".join(lines[-10:]))
        try:
            line = proc._spawn_queue.get(timeout=min(remaining, 0.5))
        except queue.Empty:
            continue
        if line is None:
            proc._spawn_queue.put(None)
            for i in range(seen, len(lines)):
                m = rx.search(lines[i])
                if m:
                    return m
            raise AssertionError(
                f"{proc._spawn_label} ended (rc={proc.wait()}) before "
                f"printing {pattern!r}:\n" + "".join(lines[-10:]))
        lines.append(line)


def line_time(proc, pattern: str, after: float = 0.0) -> Optional[float]:
    """The monotonic time the process's first line matching `pattern` (and
    read at or after `after`) arrived from its pipe, or None."""
    rx = re.compile(pattern)
    for t, line in list(proc._spawn_stamps):
        if t >= after and rx.search(line):
            return t
    return None


def spawn_scheduler(url: str, *extra_args: str, timeout: float = 120.0,
                    env: Optional[dict] = None, label: str = "scheduler"):
    """Start `python -m karmada_tpu_torch.sched --server URL <extra_args>`
    and return the process once its `attached` line appears."""
    proc, _ = spawn_process(
        [sys.executable, "-m", "karmada_tpu_torch.sched", "--server", url,
         *extra_args],
        r"karmada-tpu scheduler attached to ", timeout=timeout, label=label,
        env=env,
    )
    return proc


def spawn_daemon(*extra_args: str, scheme: str = "http",
                 timeout: float = 60.0):
    """The control-plane daemon (`python -m karmada_tpu.server` in the
    reference) builds a `ControlPlane`, which the port does not have yet."""
    raise NotImplementedError(
        "spawn_daemon: the control-plane daemon (server/__main__.py) needs "
        "the ControlPlane, which is not ported yet (ROADMAP queue A item 12)")
