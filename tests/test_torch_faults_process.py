"""The fault plan's process pieces, the retry policies and the estimator
flag parser of the port, held against the JAX package's on the CPU.

- `FaultPlan` JSON round trips (`to_json` / `from_json` / `from_dict`)
  give the same document in both packages, and `schedule()` /
  `process_schedule()` / `trace_bytes()` give the same bytes for the
  same seed;
- `install_from_env` with inline JSON, with a file path and with a
  malformed plan (which raises, persistently, through `active()`);
- the HTTP boundary: a `RemoteStore` under an installed HTTP rule fails
  exactly the operations the plan schedules;
- `RetryPolicy` and `Backoff` delays equal the reference's for the same
  draws, and their `run()` budgets;
- `parse_estimator_flags`, including its SystemExit text.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu import faults as jfaults  # noqa: E402
from karmada_tpu.estimator.client import parse_estimator_flags as jparse  # noqa: E402

from karmada_tpu_torch import faults  # noqa: E402
from karmada_tpu_torch.estimator.client import parse_estimator_flags  # noqa: E402

SEEDS = (0, 7, 42)


@pytest.fixture(autouse=True)
def _no_ambient_plan(monkeypatch):
    monkeypatch.delenv(faults.ENV_FAULT_PLAN, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def plan_doc(seed: int) -> dict:
    return {
        "seed": seed,
        "rules": [
            {"boundary": "grpc", "target": "m1", "kind": "flap", "period": 3},
            {"boundary": "grpc", "target": "m2", "kind": "partition",
             "after": 2, "heal_after": 6},
            {"boundary": "http", "kind": "error", "rate": 0.5, "heal_after": 50},
            {"boundary": "apply", "target": "m3", "kind": "latency",
             "latency": 0.001, "rate": 0.25},
        ],
        "process_rules": [
            {"kind": "leader_kill", "wave": 2},
            {"kind": "shard_kill", "rate": 0.5},
            {"kind": "partition", "target": "follower-1", "rate": 0.3},
            {"kind": "estimator_blackout", "wave": 0},
        ],
    }


def both(seed: int):
    doc = plan_doc(seed)
    return faults.FaultPlan.from_dict(doc), jfaults.FaultPlan.from_dict(doc)


class TestPlanParity:
    def test_literals_match_reference(self):
        for name in ("BOUNDARY_HTTP", "BOUNDARY_GRPC", "BOUNDARY_APPLY", "BOUNDARIES",
                     "PROCESS_KINDS", "ENV_FAULT_PLAN", "KINDS"):
            assert getattr(faults.plan, name) == getattr(jfaults.plan, name), name
        for name in ("BOUNDARY_HTTP", "BOUNDARY_APPLY", "ENV_FAULT_PLAN",
                     "PROCESS_KINDS", "ProcessEvent", "ProcessFaultRule",
                     "install_from_env", "RetryPolicy", "Backoff"):
            assert hasattr(faults, name), name

    @pytest.mark.parametrize("seed", SEEDS)
    def test_json_round_trip_equals_reference(self, seed):
        port, ref = both(seed)
        assert port.to_json() == ref.to_json()
        back = faults.FaultPlan.from_json(ref.to_json())
        assert back.to_json() == port.to_json()
        assert back.process_rules == port.process_rules
        assert faults.FaultPlan.from_json(
            faults.FaultPlan(seed=seed, rules=port.rules).to_json()
        ).process_rules == []
        assert "process_rules" not in faults.FaultPlan(seed=seed, rules=port.rules).to_json()

    @pytest.mark.parametrize("seed", SEEDS)
    def test_schedules_equal_reference_bytes(self, seed):
        port, ref = both(seed)
        for boundary, target in (("grpc", "m1"), ("grpc", "m2"), ("http", "x:1"),
                                 ("http", "127.0.0.1:8080"), ("apply", "m3"),
                                 ("apply", "m-unlisted")):
            assert port.schedule(boundary, target, 128) == \
                ref.schedule(boundary, target, 128)
        assert port.process_schedule(64) == ref.process_schedule(64)
        for w in range(8):
            assert [(e.kind, e.target, e.wave) for e in port.process_events(w)] == \
                [(e.kind, e.target, e.wave) for e in ref.process_events(w)]

    def test_seed_moves_the_probabilistic_firings(self):
        a, _ = both(11)
        b, _ = both(12)
        assert a.schedule("http", "x:1", 256) != b.schedule("http", "x:1", 256)
        assert a.process_schedule(64) != b.process_schedule(64)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_injector_trace_bytes_equal_reference(self, seed):
        port, ref = both(seed)
        traces = []
        for mod, plan in ((faults, port), (jfaults, ref)):
            inj = mod.FaultInjector(plan)
            for _ in range(12):
                for boundary, target in (("grpc", "m1"), ("http", "h:1"),
                                         ("apply", "m3")):
                    try:
                        inj.check(boundary, target)
                    except mod.InjectedFault:
                        pass
            traces.append(inj.trace_bytes())
        assert traces[0] == traces[1] and traces[0]

    def test_validate_rejects_bad_process_rules(self):
        for rule in ({"kind": "meteor_strike"}, {"kind": "leader_kill", "rate": 1.5},
                     {"kind": "leader_kill", "wave": -2}):
            with pytest.raises(ValueError) as port_err:
                faults.FaultPlan.from_dict({"seed": 1, "process_rules": [rule]})
            with pytest.raises(ValueError) as ref_err:
                jfaults.FaultPlan.from_dict({"seed": 1, "process_rules": [rule]})
            assert str(port_err.value) == str(ref_err.value)


class TestInstallFromEnv:
    def test_unset_installs_nothing(self):
        assert faults.install_from_env() is None
        assert faults.active() is None
        faults.check(faults.BOUNDARY_HTTP, "x:1")  # no-op

    def test_inline_json(self, monkeypatch):
        port, _ = both(3)
        monkeypatch.setenv(faults.ENV_FAULT_PLAN, port.to_json())
        faults.reset()
        inj = faults.active()
        assert inj is not None and faults.active() is inj  # minted once
        assert inj.plan.to_json() == port.to_json()

    def test_file_path(self, monkeypatch, tmp_path):
        port, _ = both(4)
        f = tmp_path / "plan.json"
        f.write_text(port.to_json())
        monkeypatch.setenv(faults.ENV_FAULT_PLAN, str(f))
        inj = faults.install_from_env()
        assert inj is not None and inj.plan.to_json() == port.to_json()
        assert faults.active() is inj

    def test_malformed_plan_raises_persistently(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_FAULT_PLAN,
                           '{"rules": [{"boundary": "grpc", "kind": "nope"}]}')
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.install_from_env()
        monkeypatch.setenv(faults.ENV_FAULT_PLAN, '{"rules": "nope"}')
        faults.reset()
        for _ in range(3):
            with pytest.raises(Exception):
                faults.active()
        with pytest.raises(Exception):
            faults.check(faults.BOUNDARY_GRPC, "m1")


class TestHttpBoundary:
    def test_remote_store_fails_exactly_the_scheduled_ops(self):
        """An installed HTTP rule fails the RemoteStore calls whose op index
        the plan's schedule marks, with the transport's own RemoteError."""
        from karmada_tpu_torch.server.apiserver import ControlPlaneServer
        from karmada_tpu_torch.server.remote import RemoteError, RemoteStore
        from karmada_tpu_torch.testing.daemon import MiniPlane

        srv = ControlPlaneServer(MiniPlane(coordinator=None))
        srv.start()
        plan = faults.FaultPlan(seed=5, rules=[
            faults.FaultRule(boundary="http", kind="error", rate=0.3)])
        rs = RemoteStore(srv.url)
        try:
            target = rs._fault_target
            want = [line.split(":")[1] != "-"
                    for line in plan.schedule("http", target, 40).decode().split("\n")]
            faults.install(plan)
            got = []
            for _ in range(40):
                try:
                    rs.kinds()
                    got.append(False)
                except RemoteError as e:
                    assert "control plane unreachable" in str(e)
                    got.append(True)
            assert got == want and any(got) and not all(got)
        finally:
            faults.reset()
            rs.close()
            srv.stop()


class TestRetryPolicies:
    @pytest.mark.parametrize("u", (0.0, 0.25, 0.5, 1.0))
    def test_delays_equal_reference(self, u):
        for kw in ({}, {"base_delay": 1.0, "max_delay": 8.0, "multiplier": 2.0},
                   {"base_delay": 0.2, "max_delay": 2.0}):
            port, ref = faults.RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
            assert port == faults.RetryPolicy(**kw)
            for attempt in range(10):
                assert port.delay(attempt, u=u) == ref.delay(attempt, u=u)
        draws = [0.9, 0.1, 0.5, 0.7, 0.3, 1.0]
        a = faults.Backoff(base=0.5, cap=2.0, rng=iter(draws).__next__)
        b = jfaults.Backoff(base=0.5, cap=2.0, rng=iter(draws).__next__)
        assert [a.next() for _ in range(3)] == [b.next() for _ in range(3)]
        assert a.peek_cap() == b.peek_cap()
        a.reset()
        b.reset()
        assert [a.next() for _ in range(3)] == [b.next() for _ in range(3)]

    def test_backoff_streak_and_reset(self):
        bo = faults.Backoff(base=0.5, cap=2.0, rng=lambda: 1.0)
        assert [bo.next(), bo.next(), bo.next(), bo.next()] == [0.5, 1.0, 2.0, 2.0]
        bo.reset()
        assert bo.next() == 0.5

    def test_run_retries_gives_up_and_keeps_deadline(self):
        calls = {"n": 0}
        sleeps: list[float] = []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("transient")
            return "ok"

        assert faults.RetryPolicy(max_attempts=5).run(
            flaky, retryable=lambda e: isinstance(e, ConnectionError),
            sleep=sleeps.append, rng=lambda: 1.0) == "ok"
        assert calls["n"] == 3 and sleeps == [0.1, 0.2]
        with pytest.raises(ValueError):
            faults.RetryPolicy().run(
                lambda: (_ for _ in ()).throw(ValueError("terminal")),
                retryable=lambda e: False, sleep=lambda s: None)
        t = [0.0]
        calls["n"] = 0

        def slow():
            calls["n"] += 1
            t[0] += 10.0
            raise ConnectionError("slow failure")

        with pytest.raises(ConnectionError):
            faults.RetryPolicy(max_attempts=10, deadline=15.0, base_delay=6.0,
                               multiplier=1.0).run(
                slow, retryable=lambda e: True, sleep=lambda s: None,
                clock=lambda: t[0], rng=lambda: 1.0)
        assert calls["n"] == 2

    def test_remote_store_policies_equal_reference(self):
        from karmada_tpu.server import remote as jremote

        from karmada_tpu_torch.server import remote

        assert remote.WRITE_RETRY == faults.RetryPolicy(**vars(jremote.WRITE_RETRY))
        assert remote.BATCH_RETRY == faults.RetryPolicy(**vars(jremote.BATCH_RETRY))


class TestEstimatorFlags:
    @pytest.mark.parametrize("specs", [
        [],
        ["m1=10.0.0.1:10352"],
        ["m1=h1:1", "m2=h2:2", "m1=h3:3"],
        ["a=b=c:1"],
    ])
    def test_address_maps_equal_reference(self, specs):
        assert parse_estimator_flags(specs) == jparse(specs)

    @pytest.mark.parametrize("bad", ["m1", "=h:1", "m1=", "m1:h:1"])
    def test_malformed_spec_exits_with_reference_text(self, bad):
        with pytest.raises(SystemExit) as port_exit:
            parse_estimator_flags(["ok=h:1", bad])
        with pytest.raises(SystemExit) as ref_exit:
            jparse(["ok=h:1", bad])
        assert str(port_exit.value) == str(ref_exit.value)
        assert str(port_exit.value) == f"--estimator {bad!r}: want CLUSTER=HOST:PORT"
