"""Descheduler daemon: `python -m karmada_tpu_torch.descheduler --server URL
...` (the port's copy of the reference's descheduler/__main__.py).

The reference's cmd/descheduler binary (descheduler.go:141): a standalone
process that, every --descheduling-interval, lists Divided+Dynamic
bindings over the control-plane API, asks the per-cluster scheduler
estimators for unschedulable counts over gRPC, and shrinks assignments so
the scheduler re-places the freed replicas. Here the control-plane side
rides RemoteStore.

The device: the reference forces its CPU backend here, as a host-plane
process; the port follows its own entry-point rule instead, as the
scheduler process does: `--platform` unset (or `cuda`) means the CUDA card,
and without one the process exits non-zero with the RuntimeError; `--platform
cpu` runs the plain PyTorch path. Only `--dry-run` uses the device (its
re-placement runs through the Simulator there); the sweep is host work.

Not ported yet, exiting with an error that names its queue item:
`--estimator` (the gRPC wire to the scheduler-estimators, item 9). Without
it the unschedulable estimators answer nothing, as in the reference, and
clusters fall back to the bindings' aggregated ready counts alone.

Example:
    python -m karmada_tpu_torch.descheduler --server http://127.0.0.1:7443
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m karmada_tpu_torch.descheduler")
    ap.add_argument("--server", required=True,
                    help="control-plane URL (http:// or https://)")
    ap.add_argument("--estimator", action="append", default=[],
                    metavar="CLUSTER=HOST:PORT",
                    help="scheduler-estimator address per member cluster; "
                         "repeatable. Clusters without one fall back to the "
                         "binding's aggregated ready counts alone (not "
                         "ported yet)")
    ap.add_argument("--interval", type=float, default=120.0,
                    help="seconds between sweeps (--descheduling-interval)")
    ap.add_argument("--threshold", type=float, default=300.0,
                    help="unschedulable-threshold seconds")
    ap.add_argument("--once", action="store_true",
                    help="run one sweep and exit (prints the update count); "
                         "operator-invoked, so it skips leader election")
    ap.add_argument("--details", type=int, default=16,
                    help="max per-binding diffs carried in the --dry-run "
                         "report (-1 = all)")
    ap.add_argument("--dry-run", action="store_true",
                    help="compute the eviction set, run it through the "
                         "what-if simulator instead of patching bindings, "
                         "and print the displacement report (JSON). Mutates "
                         "nothing; implies --once")
    ap.add_argument("--scrape-token-file", default="",
                    help="dedicated READ-ONLY token accepted on GET "
                         "/metrics only (the Prometheus credential no "
                         "longer needs to be the full wire token)")
    ap.add_argument("--platform", default="",
                    help="the dry run's device: cpu runs the plain PyTorch "
                         "path; default (or cuda) = the CUDA card, and the "
                         "process exits non-zero without one")
    ap.add_argument("--bearer-token", default="")
    ap.add_argument("--cacert", default="")
    ap.add_argument("--no-leader-elect", action="store_true",
                    help="sweep without holding the karmada-descheduler "
                         "lease (UNSAFE with more than one instance)")
    ap.add_argument("--lease-duration", type=float, default=15.0)
    ap.add_argument("--identity", default="",
                    help="election identity (default hostname_pid)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve GET /metrics on this port (0 = ephemeral, "
                         "printed on stdout; -1 disables)")
    args = ap.parse_args()
    if args.platform not in ("", "cpu", "cuda"):
        ap.error(f"--platform {args.platform!r}: want cpu or cuda")
    device = "cpu" if args.platform == "cpu" else None

    from ..estimator.client import EstimatorRegistry, parse_estimator_flags
    from ..server.remote import RemoteStore
    from .descheduler import Descheduler

    # flag validation first: a malformed --estimator exits with the
    # reference's SystemExit text before anything else boots
    addresses = parse_estimator_flags(args.estimator)
    if addresses:
        ap.exit(2, f"{ap.prog}: --estimator: the scheduler-estimator gRPC "
                   "wire (estimator/service.py) is not ported yet "
                   "(ROADMAP queue A item 9)\n")
    registry = EstimatorRegistry()

    token = args.bearer_token or os.environ.get("KARMADA_TOKEN") or None
    store = RemoteStore(
        args.server,
        token=token,
        cafile=args.cacert or os.environ.get("KARMADA_CACERT") or None,
    )
    try:
        # device=None (the card) raises RuntimeError here without one
        d = Descheduler(store, registry, interval=args.interval,
                        unschedulable_threshold=args.threshold,
                        device=device)
    except BaseException:
        store.close()
        raise
    if args.dry_run:
        import dataclasses
        import json

        try:
            report = d.deschedule_dryrun(
                diff_limit=(1 << 20) if args.details < 0 else args.details
            )
        finally:
            store.close()
        row = report.scenarios[0] if report.scenarios else None
        print(json.dumps({
            "dry_run": True,
            "evicted_bindings": report.bindings,
            "displaced": row.displaced if row else 0,
            "unplaceable": row.unplaceable if row else 0,
            "overcommitted": row.overcommitted if row else [],
            "diffs": [dataclasses.asdict(di) for di in (row.diffs if row else [])],
        }), flush=True)
        return
    if args.once:
        try:
            n = d.deschedule_once()
        finally:
            store.close()
        print(f"descheduled {n} binding(s)", flush=True)
        return

    from ..api.coordination import LEASE_DESCHEDULER
    from ..coordination.elector import Elector, default_identity
    from ..server.metricsserver import start_metrics_server

    metrics_srv = start_metrics_server(
        args.metrics_port, token=token,
        scrape_token_file=args.scrape_token_file,
    )
    identity = args.identity or default_identity()
    elector = None
    if not args.no_leader_elect:
        def started(token_: int) -> None:
            store.set_fence(LEASE_DESCHEDULER, token_)
            print(f"leader: {identity} acquired lease {LEASE_DESCHEDULER} "
                  f"(fencing token {token_})", flush=True)

        def stopped(reason: str) -> None:
            store.clear_fence()
            print(f"leader: {identity} lost lease {LEASE_DESCHEDULER} "
                  f"({reason})", flush=True)

        elector = Elector(
            store, LEASE_DESCHEDULER, identity,
            lease_duration=args.lease_duration,
            on_started_leading=started, on_stopped_leading=stopped,
        )
        elector.step()
        elector.run()
    print(f"karmada-tpu descheduler sweeping {args.server} "
          f"every {args.interval:.0f}s", flush=True)
    try:
        while True:
            if elector is None or elector.is_leader:
                try:
                    n = d.deschedule_once()
                    if n:
                        print(f"descheduled {n} binding(s)", flush=True)
                except Exception:  # noqa: BLE001 - survive transient errors
                    import logging

                    logging.getLogger(__name__).exception("descheduling sweep")
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if elector is not None:
            elector.stop(release=True)
        if metrics_srv is not None:
            metrics_srv.stop()
        store.close()


if __name__ == "__main__":
    sys.exit(main())
