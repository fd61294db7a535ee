"""Launch a real multi-process cluster run: coordinator + worker processes.

The wall-clock twin of ``repro_torch.launch.serve``: instead of simulating a
fleet, this spawns ``--workers`` OS processes on localhost, serves a
Poisson-ish request stream through the replicated dispatch fabric
(first-replica-wins, CANCEL on completion) or — with ``--coding`` — the
coded k-of-n quorum, optionally injects one chaos fault
(``--chaos kill|pause|slow|late-join``), and — with ``--tuner`` —
lets the StragglerTuner re-plan (B, policy) online from the measured,
censored telemetry.  Prints a JSON summary plus the control-plane event
log.  ``--device`` is the torch device of the planners and of ``matmul``
payloads (default: cuda, which must be present; ``cpu`` runs on the host).

Run: PYTHONPATH=src python -m repro_torch.launch.cluster --workers 8 --chaos pause
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.cluster import (
    ChaosEvent,
    ChaosInjector,
    ClusterConfig,
    LocalCluster,
    drive,
    make_deterministic_spec,
    make_matmul_spec,
    make_sleep_spec,
)
from repro_torch.core import CodingCandidate, PolicyCandidate
from repro_torch.serving.queueing import Request

__all__ = ["build_config", "run_cluster", "main"]


def build_config(args) -> ClusterConfig:
    if args.payload == "sleep":
        payload = make_sleep_spec(
            "sexp" if args.delta > 0 else "exp",
            work=args.work,
            delta=args.delta,
            mu=args.mu,
        )
    elif args.payload == "deterministic":
        payload = make_deterministic_spec(args.work)
    else:
        payload = make_matmul_spec(size=args.matmul_size)
    policy = (
        PolicyCandidate(
            kind=args.policy,
            quantile=args.quantile,
            hedge_fraction=args.hedge_fraction,
        )
        if args.policy != "none"
        else None
    )
    coding = (
        CodingCandidate(scheme=args.coding, s=args.coding_s)
        if args.coding != "none"
        else None
    )
    return ClusterConfig(
        n_workers=args.workers,
        n_batches=args.batches,
        batch_size=args.batch_size,
        max_wait=args.max_wait,
        heartbeat_interval=args.heartbeat_interval,
        heartbeat_timeout=args.heartbeat_timeout,
        payload=payload,
        metric=args.metric,
        tuner=args.tuner,
        planner_mode=args.planner,
        min_samples=args.min_samples,
        policy=policy,
        coding=coding,
        seed=args.seed,
        device=args.device,
    )


def chaos_events(args, base: float) -> list[ChaosEvent]:
    at = base + args.chaos_at
    if args.chaos == "kill":
        return [ChaosEvent(at=at, kind="kill", worker=args.chaos_worker)]
    if args.chaos == "pause":
        return [
            ChaosEvent(
                at=at, kind="pause", worker=args.chaos_worker,
                arg=args.chaos_arg,
            )
        ]
    if args.chaos == "slow":
        return [
            ChaosEvent(
                at=at, kind="slow", worker=args.chaos_worker,
                arg=args.chaos_arg,
            )
        ]
    if args.chaos == "late-join":
        return [ChaosEvent(at=at, kind="spawn", arg=0.0)]
    return []


def run_cluster(args) -> dict:
    cfg = build_config(args)
    rng = np.random.default_rng(args.seed)
    gaps = rng.exponential(args.interarrival, size=args.requests)
    with LocalCluster(cfg) as cluster:
        coord = cluster.coordinator
        base = coord.now()
        t = base
        for i in range(args.requests):
            t += gaps[i]
            coord.submit(Request(request_id=i, arrival=t))
        injector = ChaosInjector(cluster, chaos_events(args, base))
        drive(cluster, injector, timeout=args.timeout)
        summary = coord.summary()
        summary["events"] = [
            {"t": round(t_, 4), "kind": k, "detail": d}
            for t_, k, d in coord.events
            if k != "join"
        ]
        return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batches", type=int, default=None,
                    help="initial B (must divide --workers; default: planner)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--interarrival", type=float, default=0.02,
                    help="mean seconds between request arrivals")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--max-wait", type=float, default=0.02)
    ap.add_argument("--heartbeat-interval", type=float, default=0.05)
    ap.add_argument("--heartbeat-timeout", type=float, default=0.4)
    ap.add_argument("--payload", choices=("sleep", "deterministic", "matmul"),
                    default="sleep")
    ap.add_argument("--work", type=float, default=1.0,
                    help="work units per request (deterministic: seconds)")
    ap.add_argument("--delta", type=float, default=0.01,
                    help="sleep payload: shift of the SExp service model")
    ap.add_argument("--mu", type=float, default=30.0,
                    help="sleep payload: exponential tail rate")
    ap.add_argument("--matmul-size", type=int, default=256)
    ap.add_argument("--metric", default="p99",
                    choices=("mean", "p50", "p95", "p99", "p999"))
    ap.add_argument("--tuner", action="store_true",
                    help="re-plan (B, policy) online from measured telemetry")
    ap.add_argument("--planner", default="simulate",
                    choices=("analytic", "simulate", "empirical"))
    ap.add_argument("--min-samples", type=int, default=48)
    ap.add_argument("--policy", default="none",
                    choices=("none", "clone", "relaunch", "hedged"))
    ap.add_argument("--quantile", type=float, default=0.95)
    ap.add_argument("--hedge-fraction", type=float, default=0.25)
    ap.add_argument("--coding", default="none",
                    choices=("none", "cyclic", "mds", "poly"),
                    help="coded k-of-n quorum dispatch (needs sleep payload; "
                         "excludes --tuner/--policy)")
    ap.add_argument("--coding-s", type=int, default=1,
                    help="straggler tolerance s of the coded scheme")
    ap.add_argument("--chaos", default="none",
                    choices=("none", "kill", "pause", "slow", "late-join"))
    ap.add_argument("--chaos-at", type=float, default=0.5,
                    help="seconds after the stream starts")
    ap.add_argument("--chaos-worker", type=int, default=0)
    ap.add_argument("--chaos-arg", type=float, default=1.0,
                    help="pause: resume delay (s); slow: the factor")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the planners and of matmul "
                         "payloads (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    summary = run_cluster(args)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
