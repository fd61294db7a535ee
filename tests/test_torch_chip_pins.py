"""The decisions ``chip_smoke.py`` holds the card to, computed from the
reference.

``chip_smoke.py`` cannot import the reference (its machine has no JAX), so
it carries the reference's decisions as constants; here each is recomputed
live from ``src/repro`` at the card's own size and held equal to the
constant:

* ``HETERO_DECISIONS`` — ``benchmarks/bench_planner.py``'s skewed fleet (N
  64, SExp(0.25, 1.0), rates [0.1] + linspace(0.7, 1.3, 63), 20,000
  trials): B* under "mean" (the port too, bit for bit: the coverage path
  is float64), the ``drop_slowest(4)`` shrink's B* and dropped workers,
  and (B*, policy) under the load-aware p99 portfolio on the reference's
  ``pallas`` lane.
* ``EMPIRICAL_DECISIONS`` — the same bench's 2,000-draw pool: B*,
  confidence and vote share at K 4, 16 and 64 (the port too at K 4 and
  16).
* ``SWITCH_DECISION`` — ``benchmarks/bench_serving_latency.py``'s online
  policy switch at its full 4,000 trials on the reference's ``pallas``
  lane: the policy adopted in each regime, every move and the final B.
  ``tests/test_torch_tuner.py`` holds the port's tuner to the
  reference's, attempt by attempt, at 600 trials.
* ``ENGINE_MULTITENANT``, ``ENGINE_FLEET`` and ``ENGINE_MODEL`` — phase
  4d's serving engine (``chip_smoke.engine_kwargs`` builds the
  reference's configurations too): ``benchmarks/bench_multitenant.py``'s
  FIFO and swept deployments on 16 groups (4,000 requests) and on 1,024
  (40,000), their ``run_load`` decision and per-class numbers; the
  tuner-on engine's moves, final B, policy and p99 sojourn (2,000
  requests).  Every planner call on the reference's ``pallas`` lane at
  the engine's own 4,000 trials; ``tests/test_torch_serving_engine.py``
  holds the port's CPU lane bit-equal to that lane on the same kinds of
  engine at smaller sizes.

Reference sweeps start from an empty group-minima cache.
"""

import os
import sys

import numpy as np

from repro.core import planner as RP
from repro.core import simulator as RS
from repro.core import tuner as RT
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import PolicyCandidate as RPol
from repro.core.replication import ReplicationPlan as RPlan
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (its constants; main() is not run)

# benchmarks/bench_planner.py's fleet (and chip_smoke.py's plan_heterogeneous
# and plan_empirical): N 64, SExp(0.25, 1.0), one crippled host
BENCH_N = 64
BENCH_DIST = RSExp(0.25, 1.0)
BENCH_RATES = tuple(np.concatenate([[0.1], np.linspace(0.7, 1.3, 63)]))
BENCH_POLS = (RPol(), RPol("clone", quantile=0.9),
              RPol("relaunch", quantile=0.9), RPol("hedged", hedge_fraction=0.1))


def _clear():
    RS._GROUP_MIN_CACHE.clear()


def _points(plan):
    return [(p.n_batches, p.replication, p.mean, p.var, p.p99, p.p999)
            for p in plan.spectrum.points]


def _same_plan(ref, port):
    assert (port.n_batches, port.confidence, port.vote_share) == (
        ref.n_batches, ref.confidence, ref.vote_share)
    assert port.assignment.worker_batch == ref.assignment.worker_batch
    assert _points(port) == _points(ref)


def _pool(dist, n, seed):
    return REmp(tuple(dist.sample(np.random.default_rng(seed), n)))


def test_plan_heterogeneous_decisions_are_the_references():
    """chip_smoke.py's plan_heterogeneous decisions on the bench's skewed
    fleet at its full 20,000 trials, from the reference."""
    skew = RP.ClusterSpec(n_workers=BENCH_N, dist=BENCH_DIST,
                          rates=BENCH_RATES)
    mean = RP.HeterogeneousPlanner(n_trials=20_000, seed=0).plan(
        skew, RP.Objective(metric="mean"))
    shrunk, dropped = skew.drop_slowest(4)
    shrink = RP.HeterogeneousPlanner(n_trials=20_000, seed=0).plan(
        shrunk, RP.Objective(metric="mean"))
    port_mean = TP.HeterogeneousPlanner(n_trials=20_000, seed=0,
                                        device="cpu").plan(
        from_reference(skew), TP.Objective(metric="mean"))
    _same_plan(mean, port_mean)
    _clear()
    p99 = RP.HeterogeneousPlanner(n_trials=20_000, seed=0,
                                  backend="pallas").plan(
        skew, RP.Objective(metric="p99", utilization=0.7,
                           policies=BENCH_POLS))
    assert chip_smoke.HETERO_DECISIONS == {
        "mean": mean.n_batches,
        "shrink": (shrink.n_batches, dropped),
        "p99": (p99.n_batches, p99.policy.kind, p99.policy.quantile),
    }


def test_plan_empirical_decisions_are_the_references():
    """chip_smoke.py's plan_empirical decisions on the bench's 2,000-draw
    pool at its full 20,000 trials (K 4 and 16: the port too), from the
    reference."""
    pool = _pool(BENCH_DIST, 2_000, 0)
    spec = RP.ClusterSpec(n_workers=BENCH_N, dist=pool)
    got = {}
    for k in (4, 16, 64):
        _clear()
        ref = RP.EmpiricalPlanner(n_trials=20_000, seed=0, n_resamples=k,
                                  backend="pallas").plan(
            spec, RP.Objective(metric="mean"))
        got[k] = (ref.n_batches, ref.confidence, ref.vote_share)
        if k < 64:
            port = TP.EmpiricalPlanner(n_trials=20_000, seed=0,
                                       n_resamples=k, device="cpu").plan(
                from_reference(spec), TP.Objective(metric="mean"))
            _same_plan(ref, port)
    assert chip_smoke.EMPIRICAL_DECISIONS == got


def test_tuner_switch_decision_is_the_references():
    pols = (
        *(RPol("clone", quantile=q) for q in (0.8, 0.9)),
        *(RPol("relaunch", quantile=q) for q in (0.8, 0.9)),
        RPol("hedged", hedge_fraction=0.1),
        RPol("hedged", hedge_fraction=0.3),
    )
    tuner = RT.StragglerTuner(RPlan(16, 4), RT.TunerConfig(
        mode="simulate", sim_trials=4_000, sim_seed=0, min_samples=64,
        cooldown_steps=8, window_steps=16, improvement_threshold=0.05,
        metric="p99", sim_backend="pallas"), policy_candidates=pols)
    rng = np.random.default_rng(0)
    adopted, moves = [], []
    _clear()
    for dist, steps in ((RExp(2.0), 24), (RSExp(0.5, 2.0), 32)):
        for _ in range(steps):
            tuner.observe(dist.sample(rng, 16))
            tuner.observe_load(13.0)
            rp = tuner.maybe_replan()
            if rp is not None:
                moves.append((rp.step, rp.old_batches, rp.new_batches))
                tuner.apply(rp)
        pol = tuner.last_plan.policy
        adopted.append((pol.kind, pol.quantile))
    assert chip_smoke.SWITCH_DECISION == {
        "adopted": tuple(adopted), "moves": tuple(moves),
        "final_b": tuner.plan.n_batches}


# -- phase 4d: the serving engine -------------------------------------------

def _ref_engine(path, n_groups=16):
    from repro import core as RC
    from repro.serving import ReplicatedServingEngine, ServeEngineConfig

    kw = chip_smoke.engine_kwargs(RC, path, n_groups)
    return ReplicatedServingEngine(ServeEngineConfig(
        **dict(kw, execute_model=False), sim_backend="pallas"))


def test_engine_multitenant_numbers_are_the_references():
    """chip_smoke.py's engine_multitenant: bench_multitenant's FIFO
    baseline and swept deployment (16 groups, 4,000 requests), their
    run_load results, the swept plan on the reference's pallas lane."""
    n = chip_smoke.ENGINE_REQUESTS["multitenant"]
    _clear()
    got = {path: chip_smoke.engine_summary(_ref_engine(path).run_load(n))
           for path in ("fifo", "swept")}
    assert chip_smoke.ENGINE_MULTITENANT == got


def test_engine_fleet_numbers_are_the_references():
    """chip_smoke.py's engine_fleet: the same two deployments on 1,024
    groups serving 40,000 requests; the swept engine's plan at its own
    4,000 trials on the reference's pallas lane.  (The port's CPU lane
    makes this plan too: tests/test_torch_serving_engine.py holds it
    bit-equal to the pallas lane on the 16-group deployment.)"""
    n = chip_smoke.ENGINE_REQUESTS["fleet"]
    _clear()
    got = {path: chip_smoke.engine_summary(
        _ref_engine(path, chip_smoke.ENGINE_FLEET_N).run_load(n))
        for path in ("fifo", "swept")}
    assert chip_smoke.ENGINE_FLEET == got


def test_engine_model_decision_is_the_references():
    """chip_smoke.py's engine_model: the tuner-on engine (16 groups from
    B 16, the p99 portfolio, 2,000 requests, the engine's own 4,000
    trials) on the reference's pallas lane; its schedule does not depend
    on the model, so the reference runs without it."""
    n = chip_smoke.ENGINE_REQUESTS["model"]
    _clear()
    eng = _ref_engine("model")
    log = chip_smoke.replan_log(eng)
    out = eng.run_load(n)
    assert chip_smoke.ENGINE_MODEL == chip_smoke.model_decision(out, eng, log)
