"""How the scheduler process places under HTTP faults: a stub plane served
by a port ControlPlaneServer in this process, one `python -m
karmada_tpu_torch.sched --platform cpu` child under a seeded
BOUNDARY_HTTP rule (KARMADA_TPU_FAULT_PLAN), and a backlog of bindings
created after the child's cluster watch replay. Prints one JSON line a
(kind, rate) with the seconds until every binding was Scheduled, or how
many were by the deadline.

    python3 scripts/torch_wire_faults.py [--clusters 200] [--bindings 400]
        [--rates 0,0.005,0.02] [--kind error] [--deadline 120]

The streaming admission reads a drain's keys with `get_batch` (one
request per 256 keys) and, when a read fails, puts the whole drain back
in the queue: a drain of Q keys forms with probability about
(1 - rate)^(Q / 256), so an error rule at a few per cent delays the
backlog by the retried drains only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from karmada_tpu_torch import faults  # noqa: E402
from karmada_tpu_torch.api.work import CONDITION_SCHEDULED  # noqa: E402
from karmada_tpu_torch.server.apiserver import ControlPlaneServer  # noqa: E402
from karmada_tpu_torch.testing.daemon import MiniPlane, reaping, spawn_scheduler  # noqa: E402


def run(clusters, bindings, kind, rate, deadline):
    plane = MiniPlane()
    srv = ControlPlaneServer(plane)
    srv.start()
    lists = [0]
    inner = srv._watch_cache.list_page

    def list_page(k, ns, limit, token=None):
        if k == "ResourceBinding" and not token:
            lists[0] += 1
        return inner(k, ns, limit, token)

    srv._watch_cache.list_page = list_page
    done = set()
    plane.store.watch("ResourceBinding", lambda ev, rb: done.add(rb.metadata.key()) if any(
        c.type == CONDITION_SCHEDULED for c in rb.status.conditions) else None, replay=False)
    for c in sorted(clusters, key=lambda c: c.name):
        plane.store.create(c)
    env = dict(os.environ)
    if rate:
        rule = {"boundary": "http", "kind": kind, "rate": rate}
        if kind == "latency":
            rule["latency"] = 0.005
        env[faults.ENV_FAULT_PLAN] = json.dumps({"seed": 7, "rules": [rule]})
    try:
        with reaping() as reg:
            reg(spawn_scheduler(srv.url, "--platform", "cpu", "--metrics-port", "-1",
                                env=env, timeout=120))
            t0 = time.monotonic()
            while lists[0] < len(clusters) and time.monotonic() - t0 < deadline:
                time.sleep(0.05)
            t0 = time.monotonic()
            for rb in bindings:
                plane.store.create(rb)
            while len(done) < len(bindings) and time.monotonic() - t0 < deadline:
                time.sleep(0.1)
            took = time.monotonic() - t0
    finally:
        srv.stop()
    return {"kind": kind, "rate": rate, "bindings": len(bindings),
            "scheduled": len(done), "seconds": round(took, 3),
            "all": len(done) == len(bindings)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=200)
    ap.add_argument("--bindings", type=int, default=400)
    ap.add_argument("--rates", default="0,0.005,0.02")
    ap.add_argument("--kind", default="error", choices=("error", "latency"))
    ap.add_argument("--deadline", type=float, default=120.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import build_flagship

    for rate in (float(r) for r in args.rates.split(",")):
        clusters, bindings = build_flagship(n_clusters=args.clusters,
                                            n_bindings=args.bindings)
        print(json.dumps(run(clusters, bindings, args.kind, rate, args.deadline)),
              flush=True)


if __name__ == "__main__":
    main()
