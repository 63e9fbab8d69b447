"""Scheduler daemon: `python -m karmada_tpu_torch.sched --server URL` (the
port's copy of the reference's sched/__main__.py).

The reference's cmd/scheduler binary as its own OS process — and the
north-star deployment shape: the process that owns the card runs the
batched [B,C] rounds (the ported compact and dense rounds, on their CUDA
kernels), attached to a scheduler-less control plane over the serving
API. ResourceBinding/Cluster watches stream in over HTTP (RemoteStore),
scheduling results patch back the same way.

Leader election (reference: scheduler.go:33-34,188 — the binary refuses to
schedule until it holds the lock): every instance competes for the
`karmada-scheduler` LeaderLease; only the leader drains the queue and
patches placements, and its writes carry the lease's fencing token so a
deposed leader's in-flight patches bounce with 409. Non-leaders run HOT:
watches attached, fleet encoders built, every kernel library built by the
dry-round prewarm — takeover happens within one lease TTL with no
cold start. A standby re-warms once no Cluster event has arrived for
STANDBY_SETTLE_S (port-only): the reference re-warms on every tick, which
during a watch replay of thousands of clusters (or its re-attaches)
rebuilds the fleet once a tick and holds the process's interpreter from
the replay it waits for.

The device: the card by default (`--platform` unset or `cuda`); without
one the process exits non-zero with the RuntimeError, it never carries on
on the CPU. `--platform cpu` runs the plain PyTorch path.

Sharded plane (`--scheduler-shards N --shard-index i`): the process serves
one slot of the rendezvous shard map (sched/shards/ShardedDaemon), admits
only the bindings whose ns/uid hashes to it, elects on the
`karmada-sched-shard-<i>` lease, and runs the slot's cross-shard gang
coordinator while it leads. Run one process per slot.

Not ported yet, each exiting with an error that names its queue item:
`--estimator` (the gRPC wire to the scheduler-estimators, item 9) and
`--enable-pprof` (the profile server, item 13).

Example (HA pair, over a serving plane at <port>):
    python -m karmada_tpu_torch.sched --server http://127.0.0.1:<port> &
    python -m karmada_tpu_torch.sched --server http://127.0.0.1:<port> &
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

# seconds without a Cluster event before a standby re-warms: longer than a
# watch re-attach's pause (0.5 s), so a replay is not rebuilt mid-stream
STANDBY_SETTLE_S = 1.0


def _unported(ap: argparse.ArgumentParser, what: str, item: int) -> None:
    ap.exit(2, f"{ap.prog}: {what} is not ported yet "
               f"(ROADMAP queue A item {item})\n")


def describe_build_dir() -> str:
    """The boot line for the port's counterpart of the persistent compile
    cache: kernels/build.py's hashed library directory and its counters."""
    from ..kernels.build import BUILD_DIR, compile_counts

    try:
        n = len([p for p in os.listdir(BUILD_DIR) if p.endswith(".so")])
    except OSError:
        n = 0
    state = ("warm boot, kernel libraries load from disk" if n
             else "cold boot, this process builds its kernels")
    return (f"compile cache: {BUILD_DIR} ({n} built kernel libraries — "
            f"{state}; counters {compile_counts()})")


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m karmada_tpu_torch.sched")
    ap.add_argument("--server", required=True,
                    help="control-plane URL (http:// or https://)")
    ap.add_argument("--estimator", action="append", default=[],
                    metavar="CLUSTER=HOST:PORT",
                    help="scheduler-estimator gRPC address per member "
                         "cluster; repeatable (not ported yet)")
    ap.add_argument("--plugins", default="*",
                    help="reference --plugins semantics (enable/disable "
                         "filter and score plugins)")
    ap.add_argument("--scheduler-name", default="default-scheduler")
    ap.add_argument("--scheduler-shards", type=int, default=1,
                    help="total shard slots in the scheduler plane; this "
                         "process serves the slot named by --shard-index "
                         "and admits only the bindings whose ns/uid "
                         "rendezvous-hashes to it")
    ap.add_argument("--shard-index", type=int, default=0,
                    help="which shard slot this process serves (0-based; "
                         "leader-elects on the karmada-sched-shard-<i> "
                         "lease). Run one process per slot")
    ap.add_argument("--interval", type=float, default=0.2,
                    help="max-sleep fallback between wakeups: the daemon "
                         "wakes on every enqueue (condition variable), so "
                         "this only bounds how long an IDLE leader sleeps "
                         "before its renew/prewarm housekeeping tick")
    ap.add_argument("--batch-delay-ms", type=float, default=5.0,
                    help="streaming admission batching delay: how long a "
                         "trickle of watch events may coalesce into one "
                         "micro-batch before it launches (a backlog always "
                         "admits immediately)")
    ap.add_argument("--max-batch-rows", type=int, default=0,
                    help="drain quota per streaming micro-batch (0 = auto)")
    ap.add_argument("--no-streaming", action="store_true",
                    help="disable the streaming admission service and "
                         "restore the discrete batch-round drain loop "
                         "(decisions are identical either way). KARMADA_TPU_"
                         "STREAMING=0 is the env equivalent; this flag wins")
    ap.add_argument("--platform", default="",
                    help="the rounds' device: cpu runs the plain PyTorch "
                         "path; default (or cuda) = the CUDA card, and the "
                         "process exits non-zero without one")
    ap.add_argument("--bearer-token", default="")
    ap.add_argument("--cacert", default="")
    ap.add_argument("--no-leader-elect", action="store_true",
                    help="skip leader election and always schedule "
                         "(single-instance legacy topology; UNSAFE with "
                         "more than one scheduler daemon)")
    ap.add_argument("--lease-name", default="",
                    help="election lease name (default karmada-scheduler; "
                         "one lease per --scheduler-name partition)")
    ap.add_argument("--lease-duration", type=float, default=10.0,
                    help="lease TTL seconds; takeover happens within this")
    ap.add_argument("--renew-interval", type=float, default=0.0,
                    help="seconds between renews (default TTL/3)")
    ap.add_argument("--identity", default="",
                    help="election identity (default hostname_pid)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve GET /metrics on this port (0 = ephemeral, "
                         "printed on stdout; -1 disables)")
    ap.add_argument("--scrape-token-file", default="",
                    help="dedicated READ-ONLY token accepted on GET "
                         "/metrics only")
    ap.add_argument("--enable-pprof", action="store_true",
                    help="serve /debug/pprof (not ported yet)")
    ap.add_argument("--pprof-port", type=int, default=0,
                    help="port for --enable-pprof")
    ap.add_argument("--compile-cache-dir", default="",
                    help="accepted for the reference's command line; the "
                         "port's counterpart of the XLA cache is "
                         "kernels/build.py's hashed kernels/_build/ "
                         "directory, which every process shares")
    ap.add_argument("--no-aot-prewarm", action="store_true",
                    help="skip the standby's background kernel-build pass "
                         "(the dry-round prewarm still runs). KARMADA_TPU_"
                         "AOT_PREWARM=0 is the env equivalent; this flag "
                         "wins")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the pipelined round executor (decisions "
                         "are identical either way). KARMADA_TPU_PIPELINE=0 "
                         "is the env equivalent; this flag wins")
    ap.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive estimator failures before a member's "
                         "circuit breaker opens")
    ap.add_argument("--breaker-open-seconds", type=float, default=5.0,
                    help="seconds an open breaker fast-fails before the "
                         "half-open probe")
    args = ap.parse_args()

    sharded = args.scheduler_shards > 1
    if args.scheduler_shards < 1:
        ap.error("--scheduler-shards must be >= 1")
    if not 0 <= args.shard_index < args.scheduler_shards:
        ap.error(f"--shard-index {args.shard_index} out of range for "
                 f"--scheduler-shards {args.scheduler_shards}")
    if args.platform not in ("", "cpu", "cuda"):
        ap.error(f"--platform {args.platform!r}: want cpu or cuda")
    device = "cpu" if args.platform == "cpu" else None

    from .. import faults
    from ..estimator.client import parse_estimator_flags

    # flag validation first: a malformed --estimator exits with the
    # reference's SystemExit text before anything else boots
    addresses = parse_estimator_flags(args.estimator)
    if addresses:
        _unported(ap, "--estimator: the scheduler-estimator gRPC wire "
                      "(estimator/service.py)", 9)
    if args.enable_pprof:
        _unported(ap, "--enable-pprof: the profile server "
                      "(tracing/profile.py)", 13)

    print(describe_build_dir(), flush=True)

    from ..api.coordination import LEASE_SCHEDULER
    from ..coordination.elector import Elector, default_identity
    from ..runtime.controller import Runtime
    from ..server.metricsserver import start_metrics_server
    from ..server.remote import RemoteStore
    from .scheduler import SchedulerDaemon

    # chaos plans are env-gated (KARMADA_TPU_FAULT_PLAN); install at boot so
    # a malformed plan aborts the daemon instead of silently running clean
    if faults.install_from_env() is not None:
        print("faults: chaos plan installed from "
              f"{faults.ENV_FAULT_PLAN}", flush=True)

    token = args.bearer_token or os.environ.get("KARMADA_TOKEN") or None
    store = RemoteStore(
        args.server,
        token=token,
        cafile=args.cacert or os.environ.get("KARMADA_CACERT") or None,
    )
    runtime = Runtime()
    plugins = [p.strip() for p in args.plugins.split(",") if p.strip()]
    daemon_kwargs = dict(
        scheduler_name=args.scheduler_name, plugins=plugins,
        pipeline=False if args.no_pipeline else None,
        aot_prewarm=False if args.no_aot_prewarm else None,
        device=device,
    )
    try:
        # device=None (the card) raises RuntimeError here without one
        if sharded:
            from .shards import ShardedDaemon

            daemon = ShardedDaemon(
                store, runtime, args.shard_index, args.scheduler_shards,
                **daemon_kwargs,
            )
        else:
            daemon = SchedulerDaemon(store, runtime, **daemon_kwargs)
    except BaseException:
        store.close()
        raise
    if sharded:
        print(f"sharded plane: serving shard {args.shard_index} of "
              f"{args.scheduler_shards}", flush=True)
    print(f"device: {daemon.device}", flush=True)
    metrics_srv = start_metrics_server(
        args.metrics_port, token=token,
        scrape_token_file=args.scrape_token_file,
    )

    if sharded:
        from ..api.sharding import shard_lease_name

        lease_name = args.lease_name or shard_lease_name(args.shard_index)
    else:
        lease_name = args.lease_name or (
            LEASE_SCHEDULER if args.scheduler_name == "default-scheduler"
            else f"karmada-scheduler-{args.scheduler_name}"
        )
    identity = args.identity or default_identity()
    leading = threading.Event()
    lease_token = [0]
    elector = None
    if args.no_leader_elect:
        leading.set()
        if sharded:
            daemon.xshards.start()
            daemon.publish_status(leader=identity, force=True)
    else:
        def started(token_: int) -> None:
            store.set_fence(lease_name, token_)
            daemon.abandon_prewarm()  # the leader's first round must not
            #   share the host with a background kernel build
            lease_token[0] = token_
            if sharded:
                # takeover: the coordinator resumes pending cross-shard
                # cohorts, and the re-list re-places whatever the deposed
                # leader had in flight (its patches bounce on the fence)
                daemon.xshards.start()
                daemon.relist()
            leading.set()
            if sharded:
                daemon.publish_status(leader=identity, token=token_,
                                      force=True)
            print(f"leader: {identity} acquired lease {lease_name} "
                  f"(fencing token {token_})", flush=True)

        def stopped(reason: str) -> None:
            leading.clear()
            lease_token[0] = 0
            if sharded:
                daemon.xshards.stop()
                daemon.publish_status(force=True)
            store.clear_fence()
            print(f"leader: {identity} lost lease {lease_name} ({reason})",
                  flush=True)

        elector = Elector(
            store, lease_name, identity,
            lease_duration=args.lease_duration,
            renew_interval=args.renew_interval or None,
            on_started_leading=started, on_stopped_leading=stopped,
        )
        elector.step()  # synchronous first try: a lone daemon leads at once
        elector.run()

    streaming = not args.no_streaming and os.environ.get(
        "KARMADA_TPU_STREAMING", ""
    ) not in ("0", "off", "false")
    service = None
    if streaming:
        service = daemon.streaming(
            batch_delay=max(0.0, args.batch_delay_ms) / 1000.0,
            interval=args.interval,
            max_batch=args.max_batch_rows,
        )
        print(f"streaming admission: on (batch delay "
              f"{args.batch_delay_ms:g} ms; leader-only)", flush=True)
    wake = threading.Event()
    if service is None:
        # batch mode still gets the condition-variable wakeup: an enqueue
        # interrupts the sleep, --interval is only the max-sleep fallback
        daemon.controller.queue.on_add = wake.set

    print(f"karmada-tpu scheduler attached to {args.server}", flush=True)
    # hot standby: encoders + kernel libraries warm before (and while) not
    # leading
    daemon.prewarm()
    seen, settled_at = daemon.cluster_events, time.monotonic()
    try:
        while True:
            if leading.is_set():
                if service is not None:
                    # blocks while leading: event-driven micro-batch
                    # admission (returns on leadership loss). A transient
                    # store error at serve()'s entry backs off and retries
                    try:
                        service.serve(
                            should_stop=lambda: not leading.is_set(),
                            idle=(lambda: daemon.publish_status(
                                leader=identity, token=lease_token[0]))
                            if sharded else None,
                        )
                    except Exception:  # noqa: BLE001 - survive transients
                        import logging

                        logging.getLogger(__name__).exception(
                            "streaming admission service")
                        time.sleep(args.interval)
                else:
                    try:
                        runtime.settle()
                    except Exception:  # noqa: BLE001 - survive transients
                        import logging

                        logging.getLogger(__name__).exception(
                            "scheduling drain")
                    if sharded:
                        daemon.publish_status(leader=identity,
                                              token=lease_token[0])
                    wake.wait(args.interval)
                    wake.clear()
            else:
                # re-warm on cluster churn while standby, once it settles
                if daemon.cluster_events != seen:
                    seen, settled_at = daemon.cluster_events, time.monotonic()
                elif time.monotonic() - settled_at >= STANDBY_SETTLE_S:
                    daemon.prewarm()
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if service is not None:
            service.stop()
        if elector is not None:
            elector.stop(release=True)
        if sharded:
            daemon.xshards.stop()
        if metrics_srv is not None:
            metrics_srv.stop()
        store.close()


if __name__ == "__main__":
    sys.exit(main())
