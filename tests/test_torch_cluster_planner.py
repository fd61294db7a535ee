"""The coordinator's control plane, the port against the reference, on
the same recorded telemetry.

A live cluster's telemetry depends on the wall clock, so here both
coordinators are driven without processes: each gets a fleet of
socketpair connections (the frames they send are buffered and never
read), a clock the test advances, and the same recorded trace -- rounds
of arrivals, dispatches to every idle replica set, and per-replica
elapsed times drawn once from a seeded generator (one slowed worker),
delivered as RESULTs in completion order, losers' cancel
acknowledgements included.  Through ``_on_result`` the telemetry reaches
each tuner by the coordinator's own censoring rule; then each applies its
pending reconfiguration.  After every round the two coordinators hold the
same replica sets, generation, policy, counters and event log, and their
tuners the same last plan.  A death then routes through each
coordinator's ``FaultManager.plan_recovery`` with the survivors' rates.

The reference's simulated planners run on its ``jax`` lane (float32, the
lane the port's kernels are bit-equal to); its recovery planner is the
float64 coverage rule in both packages.  The port runs on
``device="cpu"``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import socket

import numpy as np
import pytest

from repro.cluster import coordinator as RCO
from repro.core import planner as RPL
from repro.serving import queueing as RQ
from repro_torch.cluster import coordinator as TCO
from repro_torch.cluster.payloads import make_sleep_spec
from repro_torch.convert import from_reference
from repro_torch.serving import queueing as TQ


class TraceRun:
    """One coordinator on a socketpair fleet and a test-driven clock."""

    def __init__(self, ref: bool, n: int, trace_seed: int, slow: dict,
                 **cfg):
        mod, self.queueing = (RCO, RQ) if ref else (TCO, TQ)
        if not ref:
            cfg["device"] = "cpu"
        config = mod.ClusterConfig(n_workers=n, **cfg)
        self.coord = coord = mod.ClusterCoordinator(config)
        self.clock = 0.0
        coord.now = lambda: self.clock
        if ref:  # the reference's float32 lane
            coord.planner = RPL.make_planner(
                mode=config.planner_mode, n_trials=2_000, seed=config.seed,
                backend="jax")
        self.peers = []
        for _ in range(n):
            a, b = socket.socketpair()
            a.setblocking(False)
            self.peers.append(b)
            wid = next(coord._next_worker_id)
            coord.workers[wid] = mod.WorkerHandle(
                worker_id=wid, conn=a, pid=-1, last_seen=0.0)
        coord._build_initial_generation()
        self.rng = np.random.default_rng(trace_seed)
        self.slow = slow
        self.mean = 1.0 / config.payload["mu"]
        self.next_id = 0

    def round(self, t: float) -> None:
        """Arrivals for every replica set at ``t``, dispatch, then every
        replica's RESULT in completion order and the pending reconfig."""
        coord = self.coord
        self.clock = t
        for _ in range(coord.n_groups):
            coord.submit(self.queueing.Request(request_id=self.next_id,
                                               arrival=t))
            self.next_id += 1
        coord._fire_timers()
        coord._try_dispatch()
        finish = []
        for job in list(coord.jobs.values()):
            for a in job.active_attempts():
                for w in a.workers:
                    e = float(self.rng.exponential(self.mean)
                              * self.slow.get(w, 1.0))
                    finish.append((a.dispatched + e, job.job_id,
                                   a.attempt_id, w, e))
        for tf, jid, aid, w, e in sorted(finish):
            job = coord.jobs[jid]
            att = next(a for a in job.attempts if a.attempt_id == aid)
            lost = job.done or not att.active
            self.clock = max(self.clock, job.completed if lost else tf)
            coord._on_result(w, {
                "job_id": jid, "attempt": aid, "cancelled": lost,
                "elapsed": (self.clock - att.dispatched) if lost else e})
        coord._maybe_apply_reconfig()

    def state(self) -> tuple:
        c = self.coord
        lp = c.tuner.last_plan
        return (
            [sorted(g) for g in c.groups], c.generation, c.replans,
            c.deaths, c.redispatches, c.stale_results,
            None if c.policy is None else (c.policy.kind, c.policy.quantile),
            [(t, k, d) for t, k, d in c.events],
            None if lp is None else (lp.planner, lp.n_batches,
                                     [(p.n_batches, p.mean, p.p99)
                                      for p in lp.spectrum.points]),
            c._resolved,
        )

    def close(self) -> None:
        self.coord.shutdown()
        for p in self.peers:
            p.close()


@pytest.fixture
def twins(request):
    made = []

    def make(n, trace_seed, slow, **cfg):
        pair = (TraceRun(True, n, trace_seed, slow, **cfg),
                TraceRun(False, n, trace_seed, slow, **cfg))
        made.append(pair)
        return pair

    yield make
    for pair in made:
        for d in pair:
            d.close()


def _run(ref, port, rounds, gap):
    for i in range(rounds):
        ref.round(i * gap)
        port.round(i * gap)
        assert port.state() == ref.state(), f"round {i}"


def test_initial_plan_is_the_references(twins):
    """n_batches=None: each coordinator's simulate planner picks B for the
    registered fleet from the payload's prior."""
    ref, port = twins(6, 0, {}, payload=make_sleep_spec(
        "sexp", work=1.0, delta=0.02, mu=50.0), metric="p99")
    assert port.state() == ref.state()
    assert port.coord.prior_dist == from_reference(ref.coord.prior_dist)
    assert port.coord.n_groups == ref.coord.n_groups


def test_tuner_replans_like_the_reference(twins):
    """bench_cluster.py's tuner row with the simulate planner (8 workers
    from B 8, Exp(25) service, p99): the same re-plans, from the same
    censored wall-clock telemetry, to the same replica sets."""
    ref, port = twins(
        8, 3, {0: 8.0}, n_batches=8, batch_size=1, max_wait=0.01,
        payload=make_sleep_spec("exp", work=1.0, mu=25.0), metric="p99",
        tuner=True, min_samples=40, cooldown=10, planner_mode="simulate",
        seed=3)
    _run(ref, port, 24, 0.5)
    assert port.coord.replans >= 1
    assert port.coord.n_groups < 8
    x_r, c_r = ref.coord.tuner.window_observations()
    x_p, c_p = port.coord.tuner.window_observations()
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(c_p, c_r)
    last = port.coord.tuner.last_plan
    assert last.backend == "cpu" and last.objective.load_aware


def test_recovery_replans_the_survivors_like_the_reference(twins):
    """A death after telemetry covered every slot: the rate-aware
    recovery (FaultManager.plan_recovery with the tuner's rates_for)
    makes the reference's decision; the slow worker's rate is carried."""
    ref, port = twins(
        8, 5, {6: 6.0}, n_batches=4, batch_size=1, max_wait=0.01,
        payload=make_sleep_spec("sexp", work=1.0, delta=0.02, mu=50.0),
        metric="p99", seed=5)
    _run(ref, port, 12, 0.3)
    rates_r = ref.coord.tuner.rates_for(ref.coord._slots)
    rates_p = port.coord.tuner.rates_for(port.coord._slots)
    assert rates_r is not None
    np.testing.assert_array_equal(rates_p, rates_r)
    for d in (ref, port):
        d.coord._on_worker_death(1, reason="eof")
        d.coord._maybe_apply_reconfig()
    assert port.state() == ref.state()
    assert port.coord.generation == 1 and port.coord.deaths == 1
    assert sorted(w for g in port.coord.groups for w in g) == [
        0, 2, 3, 4, 5, 6, 7]
    assert port.coord.fault.device == "cpu"
    _run(ref, port, 4, 0.3)


def test_death_without_rates_falls_back_to_the_analytic_recovery(twins):
    """Before telemetry covers every slot the recovery is homogeneous."""
    ref, port = twins(
        6, 1, {}, n_batches=3, batch_size=1, max_wait=0.01,
        payload=make_sleep_spec("sexp", work=1.0, delta=0.02, mu=50.0),
        metric="mean", seed=1)
    for d in (ref, port):
        assert d.coord.tuner.rates_for(d.coord._slots) is None
        d.coord._on_worker_death(4, reason="heartbeat")
        d.coord._maybe_apply_reconfig()
    assert port.state() == ref.state()
    _run(ref, port, 3, 0.3)
