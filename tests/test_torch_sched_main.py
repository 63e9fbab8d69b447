"""`python -m karmada_tpu_torch.sched` as its own process on the CPU: the
twin of tests/test_daemons.py's scheduler-daemon case over a port
`ControlPlaneServer` on a stub plane.

- `--platform cpu` attaches, leads (fencing token 1), places a seeded
  binding set equal to the port's in-process CPU round, and with
  `--metrics-port 0` serves /metrics;
- without `--platform cpu`, on a machine without a card, the process
  exits non-zero with the RuntimeError and never carries on on the CPU;
- the per-process sharded topology: two children, `--scheduler-shards 2
  --shard-index i`, each leading its `karmada-sched-shard-<i>` lease,
  place the seeded set (and a gang spanning both slots, committed by its
  coordinator as one batch) as the in-process round does, each binding
  once, their status objects' owned counts summing to the set;
- `--estimator m=host:1` and `--enable-pprof` exit non-zero naming their
  ROADMAP queue items, a malformed `--estimator` with the reference's
  SystemExit text;
- a `KARMADA_TPU_FAULT_PLAN` plan installs at boot, and a malformed one
  aborts the process.

Every spawn has its own timeout (the spawn helper's deadline and the
wait's).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from urllib.request import urlopen

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu_torch.runtime.controller import Clock  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler  # noqa: E402
from karmada_tpu_torch.server.apiserver import ControlPlaneServer  # noqa: E402
from karmada_tpu_torch.store.store import Store  # noqa: E402
from karmada_tpu_torch.testing.daemon import (  # noqa: E402
    MiniPlane,
    output_lines,
    reaping,
    spawn_scheduler,
    wait_for_line,
)

SPAWN_TIMEOUT = 120.0
EXIT_TIMEOUT = 60.0
SCHED = [sys.executable, "-m", "karmada_tpu_torch.sched"]


def seeded_objects():
    """A 12-cluster synthetic fleet and 40 bindings of every placement
    kind, built by the JAX package's fixtures and carried across (explicit
    uids: the tie seeds are the reference's)."""
    from karmada_tpu.testing.fixtures import (
        duplicated_placement,
        static_weight_placement,
        synthetic_fleet,
    )
    from tests.test_parallel import dyn_placement, make_binding

    from karmada_tpu_torch.convert import from_reference_objects

    clusters = synthetic_fleet(12, seed=5)
    names = [c.name for c in clusters]
    bindings = []
    for i in range(40):
        kind = i % 4
        placement = (duplicated_placement(names[:3]) if kind == 0
                     else static_weight_placement({names[1]: 1, names[4]: 3}) if kind == 1
                     else dyn_placement(aggregated=kind == 3))
        bindings.append(make_binding(f"rb-{i:02d}", 1 + i % 7, placement,
                                     cpu=0.25 * (1 + i % 3)))
    return from_reference_objects((clusters, bindings))


def exits(argv, timeout=EXIT_TIMEOUT, env=None):
    """Run a process expected to exit on its own: (rc, merged output)."""
    p = subprocess.run(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=timeout, env=env)
    return p.returncode, p.stdout


@pytest.fixture()
def plane():
    cp = MiniPlane(Clock(fixed=10_000.0))
    srv = ControlPlaneServer(cp)
    srv.start()
    yield cp, srv
    srv.stop()


def test_places_seeded_bindings_as_the_in_process_round(plane):
    cp, srv = plane
    clusters, bindings = seeded_objects()
    for c in clusters:
        cp.store.create(c)
    with reaping() as reg:
        proc = spawn_scheduler(srv.url, "--platform", "cpu", "--metrics-port", "0",
                               "--identity", "solo", timeout=SPAWN_TIMEOUT)
        reg(proc)
        lines = "".join(output_lines(proc))
        assert "leader: solo acquired lease karmada-scheduler (fencing token 1)" in lines
        assert "streaming admission: on" in lines
        assert "device: cpu" in lines
        assert re.search(r"compile cache: .*_build .*counters", lines)
        m = wait_for_line(proc, r"metrics: serving on (http://\S+/metrics)",
                          timeout=SPAWN_TIMEOUT)
        metrics_url = m.group(1)
        for rb in bindings:
            cp.store.create(rb)

        def placed():
            return sum(1 for rb in cp.store.list("ResourceBinding")
                       if rb.spec.clusters or rb.status.conditions)

        deadline = time.monotonic() + SPAWN_TIMEOUT
        while placed() < len(bindings) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert placed() == len(bindings), "".join(output_lines(proc)[-20:])
        direct = ArrayScheduler(sorted(clusters, key=lambda c: c.name), device="cpu")
        want = {rb.metadata.name: tuple(sorted((t.name, t.replicas) for t in d.targets))
                for rb, d in zip(bindings, direct.schedule(bindings)) if d.ok}
        got = {rb.metadata.name: tuple(sorted((t.name, t.replicas)
                                              for t in rb.spec.clusters))
               for rb in cp.store.list("ResourceBinding") if rb.spec.clusters}
        assert got == want and len(want) > 30
        lease = cp.store.get("LeaderLease", "karmada-scheduler", "karmada-system")
        assert lease.spec.holder_identity == "solo" and lease.spec.fencing_token == 1
        # the child observes each latency just after its batch write lands,
        # so under load a scrape can precede the last observations: read
        # until the count settles (or the deadline passes)
        deadline = time.monotonic() + 30.0
        while True:
            with urlopen(metrics_url, timeout=30) as resp:
                text = resp.read().decode()
            count = re.search(r"^karmada_placement_latency_seconds_count (\S+)$", text, re.M)
            if (count and float(count.group(1)) >= len(want)) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert 'karmada_leader_election_is_leader{identity="solo",lease="karmada-scheduler"} 1' in text
        assert count and float(count.group(1)) >= len(want)
        assert proc.poll() is None


def test_without_platform_cpu_and_no_card_exits_with_the_runtime_error(plane):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    _, srv = plane
    rc, out = exits(SCHED + ["--server", srv.url, "--metrics-port", "-1"])
    assert rc != 0
    assert "RuntimeError: karmada_tpu_torch runs on a CUDA device by default" in out
    assert "attached to" not in out and "leader:" not in out


def test_two_shard_processes_serve_their_slots(plane):
    """`--scheduler-shards 2 --shard-index i`, one child per slot over the
    wire: each leads its own shard lease, admits only its slice, and the
    slices together place every binding as the in-process CPU round, once;
    a gang whose members hash to both slots commits through the wire's
    ShardGangProposal objects as one rv-checked batch."""
    from karmada_tpu_torch.api.sharding import KIND_SHARD_GANG_PROPOSAL, SHARD_NAMESPACE
    from karmada_tpu_torch.sched.shards import shard_of_binding

    from tests.test_parallel import dyn_placement, make_binding

    from karmada_tpu_torch.convert import from_reference_objects

    cp, srv = plane
    clusters, bindings = seeded_objects()
    for salt in range(200):
        gang = from_reference_objects([make_binding(f"gang{salt}-m{j}", 2, dyn_placement(),
                                                    cpu=0.25) for j in range(3)])
        for rb in gang:
            rb.spec.gang_name, rb.spec.gang_size = f"gang{salt}", 3
        if len({shard_of_binding(rb, 2) for rb in gang}) == 2:
            break
    else:
        raise AssertionError("no gang spans both slots")
    for c in clusters:
        cp.store.create(c)
    placed_at = {}  # key -> the rv of each empty -> placed write

    def on_binding(event, rb):
        key = rb.metadata.key()
        if not rb.spec.clusters:
            placed_at.setdefault(key, []).append(None)
        elif not placed_at.get(key) or placed_at[key][-1] is None:
            placed_at.setdefault(key, []).append(rb.metadata.resource_version)

    cp.store.watch("ResourceBinding", on_binding)
    with reaping() as reg:
        procs = []
        for i in range(2):
            proc = spawn_scheduler(srv.url, "--platform", "cpu", "--metrics-port", "-1",
                                   "--scheduler-shards", "2", "--shard-index", str(i),
                                   "--identity", f"s{i}", timeout=SPAWN_TIMEOUT)
            reg(proc)
            procs.append(proc)
            wait_for_line(proc, rf"leader: s{i} acquired lease karmada-sched-shard-{i} "
                                r"\(fencing token 1\)", timeout=SPAWN_TIMEOUT)
            assert f"sharded plane: serving shard {i} of 2" in "".join(output_lines(proc))
        everything = bindings + gang
        for rb in everything:
            cp.store.create(rb)

        def settled():
            rbs = cp.store.list("ResourceBinding")
            return len(rbs) == len(everything) and all(
                rb.spec.clusters or rb.status.conditions for rb in rbs)

        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not settled() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert settled(), "".join(output_lines(procs[0])[-10:] + output_lines(procs[1])[-10:])
        direct = ArrayScheduler(sorted(clusters, key=lambda c: c.name), device="cpu")
        want = {rb.metadata.name: tuple(sorted((t.name, t.replicas) for t in d.targets))
                for rb, d in zip(everything, direct.schedule(everything)) if d.ok}
        got = {rb.metadata.name: tuple(sorted((t.name, t.replicas)
                                              for t in rb.spec.clusters))
               for rb in cp.store.list("ResourceBinding") if rb.spec.clusters}
        assert got == want and all(m.metadata.name in got for m in gang)
        # each binding placed once; the gang's first placements are one
        # batch (later bookkeeping writes of the observed generation are
        # each shard's own)
        assert all(len(v) == 2 and v[0] is None for v in placed_at.values()), placed_at
        rvs = sorted(placed_at[m.metadata.key()][1] for m in gang)
        assert rvs[-1] - rvs[0] == len(rvs) - 1, rvs
        assert not cp.store.list(KIND_SHARD_GANG_PROPOSAL, SHARD_NAMESPACE)
        for i in range(2):
            lease = cp.store.get("LeaderLease", f"karmada-sched-shard-{i}", "karmada-system")
            assert lease.spec.holder_identity == f"s{i}"
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            objs = cp.store.list("SchedulerShard", SHARD_NAMESPACE)
            if len(objs) == 2 and sum(o.status.bindings for o in objs) == len(everything):
                break
            time.sleep(0.2)
        assert sorted((o.metadata.name, o.status.leader, o.status.shards_total)
                      for o in objs) == [("scheduler-shard-0", "s0", 2),
                                         ("scheduler-shard-1", "s1", 2)]
        assert sum(o.status.bindings for o in objs) == len(everything)
        assert all(p.poll() is None for p in procs)


@pytest.mark.parametrize("flags,item", [
    (["--estimator", "m=host:1"], "item 9"),
    (["--enable-pprof"], "item 13"),
])
def test_unported_paths_exit_naming_their_item(plane, flags, item):
    _, srv = plane
    rc, out = exits(SCHED + ["--server", srv.url, "--platform", "cpu", *flags])
    assert rc != 0
    assert f"not ported yet (ROADMAP queue A {item})" in out
    assert "attached to" not in out


def test_malformed_estimator_flag_exits_with_reference_text(plane):
    _, srv = plane
    rc, out = exits(SCHED + ["--server", srv.url, "--platform", "cpu",
                             "--estimator", "m1"])
    assert rc != 0
    assert "--estimator 'm1': want CLUSTER=HOST:PORT" in out


def test_fault_plan_env_installs_at_boot_and_malformed_plan_aborts(plane):
    cp, srv = plane
    from karmada_tpu_torch import faults

    plan = faults.FaultPlan(seed=3, rules=[
        faults.FaultRule(boundary="http", kind="latency", latency=0.001, rate=0.02)])
    env = {**os.environ, faults.ENV_FAULT_PLAN: plan.to_json()}
    with reaping() as reg:
        proc = spawn_scheduler(srv.url, "--platform", "cpu", "--metrics-port", "-1",
                               env=env, timeout=SPAWN_TIMEOUT)
        reg(proc)
        assert "faults: chaos plan installed from KARMADA_TPU_FAULT_PLAN" in \
            "".join(output_lines(proc))
    bad = {**os.environ, faults.ENV_FAULT_PLAN: json.dumps({"rules": "nope"})}
    rc, out = exits(SCHED + ["--server", srv.url, "--platform", "cpu",
                             "--metrics-port", "-1"], env=bad)
    assert rc != 0 and "attached to" not in out


def test_read_bindings_equals_per_key_reads():
    """The daemon's drains read their keys in one `get_batch` (the
    reference reads each key with `try_get`): the same objects as the
    per-key reads of the same store, None for a key that is gone."""
    from karmada_tpu_torch.sched.scheduler import read_bindings

    _, bindings = seeded_objects()
    store = Store()
    for rb in bindings[:10]:
        store.create(rb)
    keys = [rb.metadata.key() for rb in bindings[:10]] + ["default/gone"]

    batched = read_bindings(store, keys)
    per_key = [store.try_get("ResourceBinding", k.partition("/")[2], k.partition("/")[0])
               for k in keys]
    assert batched[-1] is None and per_key[-1] is None
    assert [rb.metadata.key() for rb in batched[:-1]] == keys[:-1]
    assert [(rb.metadata.resource_version, rb.spec.replicas) for rb in batched[:-1]] == \
        [(rb.metadata.resource_version, rb.spec.replicas) for rb in per_key[:-1]]
