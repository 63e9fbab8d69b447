"""`python -m karmada_tpu_torch.descheduler` as its own process on the CPU,
over a port `ControlPlaneServer` on a stub plane holding a fleet and
bindings whose ready counts sit below their assignments.

- `--platform cpu --once` and `--platform cpu --dry-run` (the JSON
  report) print what the reference's process prints over the same server
  (`python -m karmada_tpu.descheduler`), and the dry run writes nothing;
- the sweeping daemon elects on the `karmada-descheduler` lease and says
  so;
- without `--platform cpu`, on a machine without a card, the process exits
  non-zero with the RuntimeError;
- `--estimator m=host:1` exits non-zero naming ROADMAP queue A item 9, a
  malformed `--estimator` with the reference's SystemExit text.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu_torch.runtime.controller import Clock  # noqa: E402
from karmada_tpu_torch.server.apiserver import ControlPlaneServer  # noqa: E402
from karmada_tpu_torch.testing.daemon import (  # noqa: E402
    MiniPlane,
    output_lines,
    reaping,
    spawn_process,
)

EXIT_TIMEOUT = 120.0
DESCHED = [sys.executable, "-m", "karmada_tpu_torch.descheduler"]
REF_DESCHED = [sys.executable, "-m", "karmada_tpu.descheduler"]


def stuck_objects():
    """A 12-cluster synthetic fleet and 12 bindings placed on three
    clusters each, ready below the assignment on a few of them (built by
    the JAX package's fixtures and carried across with explicit uids)."""
    from karmada_tpu.api.work import AggregatedStatusItem
    from karmada_tpu.testing.fixtures import synthetic_fleet
    from tests.test_parallel import dyn_placement, make_binding

    from karmada_tpu_torch.convert import from_reference_objects

    clusters = synthetic_fleet(12, seed=7)
    names = [c.name for c in clusters]
    bindings = []
    for i in range(12):
        prev = {names[(i + k) % 12]: 2 + k for k in range(3)}
        rb = make_binding(f"dm-{i:02d}", sum(prev.values()),
                          dyn_placement(aggregated=i % 2 == 0), cpu=0.5, prev=prev)
        rb.status.aggregated_status = [
            AggregatedStatusItem(cluster_name=n, status={"readyReplicas": r - (i % 3 == 0)})
            for n, r in prev.items()]
        bindings.append(rb)
    for o in clusters + bindings:
        o.metadata.uid = o.metadata.uid or f"uid-{o.metadata.name}"
    return from_reference_objects(clusters + bindings)


def exits(argv, timeout=EXIT_TIMEOUT, env=None):
    p = subprocess.run(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                       timeout=timeout, env=env)
    return p.returncode, p.stdout


def ref_env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


def store_image(store) -> str:
    from karmada_tpu_torch.server import codec

    return json.dumps({kind: sorted(json.dumps(codec.encode(o), sort_keys=True)
                                    for o in store.list(kind))
                       for kind in sorted(store.kinds())}, sort_keys=True)


@pytest.fixture()
def plane():
    cp = MiniPlane(Clock(fixed=10_000.0))
    for o in stuck_objects():
        cp.store.create(o)
    srv = ControlPlaneServer(cp)
    srv.start()
    yield cp, srv
    srv.stop()


def test_dry_run_prints_the_reference_processes_report(plane):
    cp, srv = plane
    before = store_image(cp.store)
    rc, out = exits(DESCHED + ["--server", srv.url, "--platform", "cpu", "--dry-run",
                               "--details", "-1"])
    assert rc == 0, out
    got = json.loads(out.strip().splitlines()[-1])
    rc, ref_out = exits(REF_DESCHED + ["--server", srv.url, "--dry-run", "--details", "-1"],
                        env=ref_env())
    assert rc == 0, ref_out
    assert got == json.loads(ref_out.strip().splitlines()[-1])
    assert got["dry_run"] is True and set(got) == {
        "dry_run", "evicted_bindings", "displaced", "unplaceable", "overcommitted", "diffs"}
    assert store_image(cp.store) == before, "the dry run wrote to the store"


def test_once_prints_the_reference_processes_count(plane):
    cp, srv = plane
    rc, out = exits(DESCHED + ["--server", srv.url, "--platform", "cpu", "--once"])
    assert rc == 0, out
    rc, ref_out = exits(REF_DESCHED + ["--server", srv.url, "--once"], env=ref_env())
    assert rc == 0, ref_out
    want = [ln for ln in ref_out.splitlines() if ln.startswith("descheduled")]
    assert want and [ln for ln in out.splitlines() if ln.startswith("descheduled")] == want


def test_sweeping_daemon_elects_on_the_descheduler_lease(plane):
    cp, srv = plane
    with reaping() as reg:
        proc, _ = spawn_process(
            DESCHED + ["--server", srv.url, "--platform", "cpu", "--interval", "0.2",
                       "--metrics-port", "-1", "--identity", "d1"],
            r"karmada-tpu descheduler sweeping", timeout=EXIT_TIMEOUT, label="descheduler")
        reg(proc)
        lines = "".join(output_lines(proc))
        assert "leader: d1 acquired lease karmada-descheduler (fencing token 1)" in lines
        lease = cp.store.get("LeaderLease", "karmada-descheduler", "karmada-system")
        assert lease.spec.holder_identity == "d1"
        assert proc.poll() is None
    assert proc.returncode is not None


def test_without_platform_cpu_and_no_card_exits_with_the_runtime_error(plane):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    _, srv = plane
    rc, out = exits(DESCHED + ["--server", srv.url, "--once"])
    assert rc != 0
    assert "RuntimeError: karmada_tpu_torch runs on a CUDA device by default" in out
    assert "descheduled" not in out


def test_estimator_flag_exits_naming_item_9(plane):
    _, srv = plane
    rc, out = exits(DESCHED + ["--server", srv.url, "--platform", "cpu", "--once",
                               "--estimator", "m=host:1"])
    assert rc != 0
    assert "not ported yet (ROADMAP queue A item 9)" in out
    rc, out = exits(DESCHED + ["--server", srv.url, "--platform", "cpu", "--estimator", "m1"])
    assert rc != 0
    assert "--estimator 'm1': want CLUSTER=HOST:PORT" in out
