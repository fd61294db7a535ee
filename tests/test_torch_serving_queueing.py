"""The port's event-driven master against the reference's, on the CPU.

``repro_torch.serving.queueing`` is a copy of ``repro.serving.queueing``
(numpy and ``heapq``).  Each case feeds both masters the same requests
(Poisson arrivals, deadlines, priorities and tenant labels from one numpy
seed) and a service sampler of its own seeded the same, so the draws
match exactly when the masters ask for them in the same order.  Held bit
for bit: every request's ``(arrival, dispatched, completion, dropped,
batch_id)``, the order of completed jobs with their groups, winners,
clone and relaunch records, and the master's ``speculations`` /
``relaunches`` / ``hedges`` / ``reconfigurations``.

Parametrised over the four disciplines, the straggler policies (none,
clone on the empirical late-quantile, relaunch on a caller's threshold,
hedged), ``max_wait`` finite and infinite, and shedding (none,
drop-on-expiry, the admission cap); then a drain-then-swap
reconfiguration with a live ``swap_policy``, ``submit_formed``,
``partition_requests``, ``late_threshold`` and ``job_observations``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import math

import numpy as np
import pytest

from repro.serving import queueing as RQ
from repro_torch.serving import queueing as TQ

N_REQ = 400
N_GROUPS = 4
REPLICAS = 3
CLASS_WEIGHTS = (("premium", 4.0), ("standard", 1.0))


def _requests(Q, seed=0, n=N_REQ):
    """Poisson arrivals, light (20 a time unit: spare sets for clones and
    hedges) then in overload (70: the queue grows, deadlines expire and
    the cap sheds), with relative deadlines, priorities and labels."""
    rng = np.random.default_rng(seed)
    rate = np.where(np.arange(n) < n // 2, 20.0, 70.0)
    times = np.cumsum(rng.standard_exponential(n) / rate)
    rel = rng.uniform(0.05, 1.5, n)
    prio = rng.integers(0, 3, n).astype(float)
    labels = np.where(rng.random(n) < 0.3, "premium", "standard")
    return [Q.Request(request_id=i, arrival=float(t), deadline=float(t + d),
                      priority=float(p), slo=str(s))
            for i, (t, d, p, s) in enumerate(zip(times, rel, prio, labels))]


def _sampler(seed=1, replicas=REPLICAS):
    rng = np.random.default_rng(seed)

    def sample(job, group):
        work = 0.05 * job.size
        return work * (1.0 + rng.standard_exponential(replicas) * 3.0)
    return sample


def _policy(Q, kind):
    if kind == "none":
        return None
    if kind == "noop":
        return Q.NoOpPolicy()
    if kind == "clone":
        return Q.ClonePolicy(late_quantile=0.7, max_clones=2)
    if kind == "relaunch":
        return Q.RelaunchPolicy(late_quantile=0.8, max_relaunches=2,
                                threshold=lambda job: 0.12 * job.size)
    return Q.HedgedDispatchPolicy(k=2, hedge_fraction=0.5)


def _queue(Q, discipline, max_wait, shed):
    return Q.QueuePolicy(
        max_batch_size=4, max_wait=max_wait, discipline=discipline,
        class_weights=CLASS_WEIGHTS if discipline == "wfq" else None,
        drop_expired=shed == "expired",
        queue_cap=12 if shed == "cap" else None)


def _record(master, requests):
    reqs = [(r.request_id, r.arrival, r.dispatched, r.completion, r.dropped,
             r.batch_id) for r in requests]
    jobs = [(j.batch_id, j.group, j.formed_at, j.dispatched, j.completed,
             j.winner, j.winner_clone, tuple(j.clone_groups),
             tuple(j.clone_dispatched), tuple(j.relaunched_at),
             tuple(r.request_id for r in j.requests),
             j.service_times.tobytes(),
             tuple(t.tobytes() for t in j.clone_service_times),
             tuple(t.tobytes() for t in j.discarded_service_times))
            for j in master.completed_jobs]
    counts = (master.speculations, master.relaunches, master.hedges,
              master.reconfigurations, master.clock, master.n_groups,
              [r.request_id for r in master.dropped_requests])
    return reqs, jobs, counts


def _run(Q, discipline, policy, max_wait, shed, on_job_complete=None,
         n_groups=N_GROUPS):
    requests = _requests(Q)
    master = Q.EventDrivenMaster(
        n_groups, _sampler(), policy=_queue(Q, discipline, max_wait, shed),
        speculation=_policy(Q, policy),
        on_job_complete=on_job_complete and on_job_complete(Q))
    for r in requests:
        master.submit(r)
    master.run()
    return _record(master, requests)


@pytest.mark.parametrize("shed", ["none", "expired", "cap"])
@pytest.mark.parametrize("max_wait", [0.15, math.inf])
@pytest.mark.parametrize("policy", ["none", "clone", "relaunch", "hedged"])
@pytest.mark.parametrize("discipline", ["fifo", "priority", "edf", "wfq"])
def test_master_is_the_references(discipline, policy, max_wait, shed):
    want = _run(RQ, discipline, policy, max_wait, shed)
    got = _run(TQ, discipline, policy, max_wait, shed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    served = [r for r in got[0] if not r[4]]
    assert served and all(r[3] >= r[2] >= r[1] for r in served)


def _reconfigure_every(period, Q_):
    """A callback that asks for a reconfiguration every ``period`` jobs:
    alternating 2 and 6 groups, a shorter max_wait, then a looser cap."""
    def make(Q):
        state = {"n": 0}

        def cb(job):
            state["n"] += 1
            if state["n"] % period:
                return None
            k = state["n"] // period
            rc = {"n_groups": 2 if k % 2 else 6}
            if k % 3 == 1:
                rc["policy"] = Q.QueuePolicy(
                    max_batch_size=3, max_wait=0.1, discipline=Q_,
                    class_weights=(CLASS_WEIGHTS if Q_ == "wfq" else None),
                    queue_cap=20)
            if k % 3 == 2:
                rc["service_sampler"] = _sampler(seed=100 + k, replicas=2)
            return rc
        return cb
    return make


@pytest.mark.parametrize("policy", ["none", "noop", "clone", "hedged"])
@pytest.mark.parametrize("discipline", ["fifo", "edf", "wfq"])
def test_drain_then_swap_reconfiguration_is_the_references(discipline,
                                                           policy):
    cb = _reconfigure_every(15, discipline)
    want = _run(RQ, discipline, policy, 0.3, "cap", on_job_complete=cb)
    got = _run(TQ, discipline, policy, 0.3, "cap", on_job_complete=cb)
    assert got == want
    assert got[2][3] > 0  # the fabric was rebuilt


def test_swap_policy_refuses_a_new_discipline_as_the_reference_does():
    for Q in (RQ, TQ):
        master = Q.EventDrivenMaster(2, _sampler(),
                                     policy=Q.QueuePolicy(discipline="fifo"))
        with pytest.raises(ValueError, match="discipline"):
            master.swap_policy(Q.QueuePolicy(discipline="edf"))


def test_submit_formed_rounds_are_the_references():
    def run(Q):
        rng = np.random.default_rng(3)
        master = Q.EventDrivenMaster(3, _sampler(), clock=1.5)
        jobs = []
        for bi, (lo, hi) in enumerate(Q.partition_requests(10, 3)):
            reqs = [Q.Request(request_id=k, arrival=1.5) for k in range(lo, hi)]
            jobs.append(master.submit_formed(
                reqs, at=1.5, service_times=rng.random(2) + bi))
        master.run()
        return [(j.batch_id, j.group, j.completed, j.winner) for j in jobs]
    assert run(TQ) == run(RQ)


@pytest.mark.parametrize("n,b", [(10, 4), (8, 4), (3, 5), (0, 2), (17, 1)])
def test_partition_requests_is_the_references(n, b):
    assert TQ.partition_requests(n, b) == RQ.partition_requests(n, b)


def test_queue_validation_is_the_references():
    bad = [dict(max_batch_size=0), dict(max_wait=0.0),
           dict(discipline="lifo"), dict(class_weights=(("a", 1.0),)),
           dict(discipline="wfq", class_weights=(("a", 0.0),)),
           dict(discipline="wfq", class_weights=(("a", 1.0), ("a", 2.0))),
           dict(queue_cap=0)]
    for kw in bad:
        with pytest.raises(ValueError) as r:
            RQ.QueuePolicy(**kw)
        with pytest.raises(ValueError) as t:
            TQ.QueuePolicy(**kw)
        assert str(t.value) == str(r.value)
    assert repr(TQ.QueuePolicy(discipline="edf")) == repr(
        RQ.QueuePolicy(discipline="edf"))


def _job(Q, relaunch, clone_wins):
    """A finished job with a relaunch, two clones and a winner."""
    job = Q.BatchJob(batch_id=0, requests=(Q.Request(0, 0.0),), formed_at=0.0,
                     group=1, dispatched=0.5)
    job.service_times = np.array([0.9, 0.7, 1.4])
    if relaunch:
        job.discarded_service_times.append(np.array([2.0, 3.0, 2.5]))
        job.relaunched_at.append(1.0)
    job.clone_groups += [2, 3]
    job.clone_dispatched += [1.2, 1.3]
    job.clone_service_times += [np.array([0.2, 0.8]), np.array([0.6, 0.5])]
    job.winner = 1
    job.winner_clone = 0 if clone_wins else -1
    job.completed = 1.4 if clone_wins else 1.7
    return job


@pytest.mark.parametrize("relaunch", [False, True])
@pytest.mark.parametrize("clone_wins", [False, True])
def test_job_observations_are_the_references(relaunch, clone_wins):
    want = RQ.job_observations(_job(RQ, relaunch, clone_wins))
    got = TQ.job_observations(_job(TQ, relaunch, clone_wins))
    assert len(got) == len(want)
    for (gt, gc), (wt, wc) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("window", [0, 7, 8, 30])
@pytest.mark.parametrize("kind", ["clone", "relaunch"])
def test_late_threshold_is_the_references(kind, window):
    obs = list(np.random.default_rng(4).exponential(1.0, window))
    job_r = RQ.BatchJob(0, (RQ.Request(0, 0.0),), 0.0)
    job_t = TQ.BatchJob(0, (TQ.Request(0, 0.0),), 0.0)
    for fixed in (None, lambda job: 0.25 * job.size):
        pr = (RQ.ClonePolicy if kind == "clone" else RQ.RelaunchPolicy)(
            late_quantile=0.85, threshold=fixed)
        pt = (TQ.ClonePolicy if kind == "clone" else TQ.RelaunchPolicy)(
            late_quantile=0.85, threshold=fixed)
        assert TQ.late_threshold(pt, job_t, obs) == RQ.late_threshold(
            pr, job_r, obs)
