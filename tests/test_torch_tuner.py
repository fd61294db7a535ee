"""The online tuner: the port's ``StragglerTuner`` against the reference's.

Each case builds both tuners from the same reference objects (the port's
through ``convert.from_reference``, its sweeps on ``device="cpu"``; the
reference's simulated and empirical planners on their ``pallas`` lane,
interpret mode), feeds both the same telemetry, and holds the port to:

* the same sequence of ``RescalePlan``s — step, old and new B, the fitted
  distribution, and the predicted values within 1e-12 relative (the
  spectra are bit-equal; the bound only absorbs a float64 rounding, none
  is expected);
* the same ``last_plan`` decision after every attempt: planner, B,
  policy, trigger, coding, confidence and vote share, the spectrum
  within 1e-12 relative;
* the same goodness-of-fit verdicts, worker rates, windows and
  objectives.

The cases mirror the reference's tuner tests (tests/test_spectrum_
estimator_tuner.py, test_planner.py, test_sim_engine.py, test_empirical.py,
test_queueing.py, test_straggler_policies.py, test_multitenant.py,
test_sojourn_kernel.py), plus the online policy switch of
``benchmarks/bench_serving_latency.py`` at 600 trials (its full 4,000 run
on the card, pinned in tests/test_torch_chip_pins.py) and a 16-worker
version of ``chip_smoke.py``'s ``tuner_fleet``: a slow worker, a fault and
a drift to a two-mode pool, re-planned through the rate-aware planner and
the gate's empirical fallback.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import simulator as RS
from repro.core import tuner as RT
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.planner import AnalyticPlanner as RAnalytic
from repro.core.policies import PolicyCandidate as RPol
from repro.core.policies import ShedPolicy as RShed
from repro.core.policies import SloClass as RSlo
from repro.core.policies import replica_major_nonoverlapping as r_layout
from repro.core.replication import ReplicationPlan as RPlan
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.core import tuner as TT
from repro_torch.core.order_stats import Empirical as TEmp

REL = 1e-12
CLASSES = (
    RSlo("premium", share=0.3, weight=4.0, deadline=0.8, miss_target=0.05),
    RSlo("batch", share=0.7, weight=1.0),
)
SWITCH_POLS = (
    *(RPol("clone", quantile=q) for q in (0.8, 0.9)),
    *(RPol("relaunch", quantile=q) for q in (0.8, 0.9)),
    RPol("hedged", hedge_fraction=0.1),
    RPol("hedged", hedge_fraction=0.3),
)


def _convert(v):
    return v if isinstance(v, np.ndarray) else from_reference(v)


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


class Twin:
    """A reference tuner and a port tuner fed the same telemetry."""

    def __init__(self, plan, cfg, ref_planner=None, **kw):
        cfg = dataclasses.replace(cfg, sim_backend="pallas")
        port_cfg = dataclasses.replace(from_reference(cfg), device="cpu")
        port_planner = None
        if ref_planner is not None:
            port_planner = type(ref_planner).__name__
            port_planner = getattr(TP, port_planner)()
        self.ref = RT.StragglerTuner(plan, cfg, planner=ref_planner, **kw)
        self.port = TT.StragglerTuner(
            from_reference(plan), port_cfg, planner=port_planner,
            **{k: _convert(v) for k, v in kw.items()})
        self.moves = []

    def observe(self, t, c=None):
        self.ref.observe(t, c)
        self.port.observe(t, c)

    def feed(self, name, *args, **kw):
        getattr(self.ref, name)(*args, **kw)
        getattr(self.port, name)(*args, **kw)

    def replan(self, apply=True):
        RS._GROUP_MIN_CACHE.clear()
        r, p = self.ref.maybe_replan(), self.port.maybe_replan()
        same_rescale(r, p)
        same_last_plan(self.ref, self.port)
        if r is not None:
            self.moves.append((r.step, r.old_batches, r.new_batches))
            if apply:
                self.ref.apply(r)
                assert self.port.apply(p) == from_reference(self.ref.plan)
        return p


def same_rescale(r, p):
    if r is None:
        assert p is None
        return
    assert p is not None
    assert (p.step, p.old_batches, p.new_batches) == (
        r.step, r.old_batches, r.new_batches)
    assert _close(r.predicted_old, p.predicted_old)
    assert _close(r.predicted_new, p.predicted_new)
    assert p.predicted_improvement == pytest.approx(r.predicted_improvement,
                                                    rel=1e-9)
    assert p.fit.dist == from_reference(r.fit.dist)
    assert p.plan is not None and p.plan.n_batches == p.new_batches


def same_last_plan(ref, port):
    a, b = ref.last_plan, port.last_plan
    if a is None:
        assert b is None
        return
    assert (b.planner, b.n_batches, b.speculation_quantile) == (
        a.planner, a.n_batches, a.speculation_quantile)
    assert b.policy == from_reference(a.policy)
    assert b.coding == from_reference(a.coding)
    assert (b.confidence, b.vote_share) == (a.confidence, a.vote_share)
    assert b.spec.n_workers == a.spec.n_workers
    assert b.spec.rates == a.spec.rates
    assert b.objective == from_reference(a.objective)
    for x, y in zip(a.spectrum.points, b.spectrum.points):
        assert (x.n_batches, x.replication) == (y.n_batches, y.replication)
        for f in ("mean", "var", "p99", "p999"):
            assert _close(getattr(x, f), getattr(y, f)), (f, x, y)
    if ref.last_gof is None:
        assert port.last_gof is None
    else:
        assert port.last_gof.rejected == ref.last_gof.rejected
        assert port.last_gof.statistic == ref.last_gof.statistic
    if a.backend is not None:
        assert b.backend == "cpu"


def _feed(twin, dist, n, steps, rng):
    for _ in range(steps):
        twin.observe(dist.sample(rng, n))


# -- tests/test_spectrum_estimator_tuner.py ------------------------------------


def test_tuner_replans_toward_optimum():
    t = Twin(RPlan(16, 16), RT.TunerConfig(min_samples=64, cooldown_steps=0))
    _feed(t, RSExp(0.01, 1.0), 16, 20, np.random.default_rng(0))
    p = t.replan()
    assert p is not None and p.new_batches < 16
    assert p.predicted_improvement > 0.1


def test_tuner_respects_cooldown_and_threshold():
    from repro.core.spectrum import optimize

    dist = RSExp(0.5, 2.0)
    t = Twin(RPlan(8, optimize(dist, 8).n_batches),
             RT.TunerConfig(min_samples=32, cooldown_steps=1000))
    _feed(t, dist, 8, 30, np.random.default_rng(1))
    assert t.replan() is None  # the cooldown
    t.ref._last_replan = t.port._last_replan = -(10**9)
    assert t.replan() is None  # already at the optimum


def test_tuner_handles_dead_workers():
    t = Twin(RPlan(4, 2), RT.TunerConfig(min_samples=8, cooldown_steps=0))
    t.observe(np.array([1.0, np.inf, 2.0, 1.5]))
    assert t.port.n_samples == t.ref.n_samples == 4
    for _ in range(10):
        t.observe(np.array([1.0, 1.1, 0.9, 1.2]))
    assert t.port.fit().dist == from_reference(t.ref.fit().dist)
    for x, y in zip(t.ref.window_observations(), t.port.window_observations()):
        np.testing.assert_array_equal(x, y)
    t.observe(np.full(4, np.inf))  # nothing usable: not recorded
    assert t.port.n_samples == t.ref.n_samples == 44


# -- tests/test_planner.py -------------------------------------------------------


class _CountingPlanner(TP.AnalyticPlanner):
    calls = 0

    def plan(self, spec, objective=None):
        self.calls += 1
        return super().plan(spec, objective)


def test_tuner_delegates_to_injected_planner():
    counting = _CountingPlanner()
    tuner = TT.StragglerTuner(TT.ReplicationPlan(16, 16),
                              TT.TunerConfig(min_samples=32, cooldown_steps=0),
                              planner=counting)
    rng = np.random.default_rng(0)
    for _ in range(10):
        tuner.observe(from_reference(RSExp(0.01, 1.0)).sample(rng, 16))
    rp = tuner.maybe_replan()
    assert counting.calls == 1 and rp is not None and rp.new_batches < 16
    assert isinstance(rp.plan, TP.Plan) and tuner.last_plan is rp.plan


def test_tuner_config_knobs_map_to_planners():
    assert isinstance(TT.TunerConfig().planner(), TP.AnalyticPlanner)
    sim = TT.TunerConfig(mode="simulate", device="cpu").planner()
    assert type(sim) is TP.SimulatedPlanner and sim.device == "cpu"
    het = TT.TunerConfig(mode="simulate", heterogeneous=True,
                         sim_trials=123).planner()
    assert isinstance(het, TP.HeterogeneousPlanner) and het.n_trials == 123
    emp = TT.TunerConfig(mode="empirical", sim_trials=321,
                         bootstrap_resamples=7).planner()
    assert isinstance(emp, TP.EmpiricalPlanner)
    assert (emp.n_trials, emp.n_resamples) == (321, 7)
    with pytest.warns(DeprecationWarning):
        legacy = TT.TunerConfig(heterogeneous=True).planner()
    assert isinstance(legacy, TP.AnalyticPlanner)
    assert TT.TunerConfig(metric="p999").objective().metric == "p999"


def test_tuner_rates_only_reach_rate_capable_planners():
    t = Twin(RPlan(8, 8), RT.TunerConfig(min_samples=16, cooldown_steps=0),
             ref_planner=RAnalytic())
    rng = np.random.default_rng(3)
    slow = np.ones(8)
    slow[2] = 10.0
    for _ in range(10):
        t.observe(RSExp(0.01, 1.0).sample(rng, 8) * slow)
    t.replan()
    assert t.port.last_plan.spec.rates is None


def test_tuner_batch_divisor_constrains_replans():
    t = Twin(RPlan(12, 2), RT.TunerConfig(min_samples=16, cooldown_steps=0),
             batch_divisor=32)
    _feed(t, RSExp(2.0, 2.0), 12, 10, np.random.default_rng(0))
    p = t.replan()
    assert p is not None and p.new_batches == 4
    assert t.port.last_plan.spec.feasible_batches() == (1, 2, 4)


def test_tuner_forced_move_off_infeasible_current_b():
    t = Twin(RPlan(12, 3), RT.TunerConfig(min_samples=16, cooldown_steps=0,
                                          improvement_threshold=0.99),
             batch_divisor=32)
    _feed(t, RSExp(0.5, 1.0), 12, 10, np.random.default_rng(1))
    p = t.replan()
    assert p is not None and p.new_batches in (1, 2, 4)
    assert p.predicted_old == np.inf and p.predicted_improvement == 1.0


# -- tests/test_sim_engine.py ----------------------------------------------------


def test_tuner_simulate_mode_replans():
    t = Twin(RPlan(16, 16), RT.TunerConfig(min_samples=64, cooldown_steps=0,
                                           mode="simulate", sim_trials=4_000))
    _feed(t, RSExp(0.01, 1.0), 16, 20, np.random.default_rng(0))
    p = t.replan()
    assert p is not None and p.new_batches < 16
    assert t.port.last_plan.backend == "cpu"


def test_tuner_worker_rates_and_rate_aware_replans():
    n = 8
    t = Twin(RPlan(n, 4), RT.TunerConfig(mode="simulate", heterogeneous=True,
                                         sim_trials=2_000, cooldown_steps=0,
                                         min_samples=64))
    rng = np.random.default_rng(1)
    slow = np.ones(n)
    slow[2] = 10.0
    for _ in range(200):
        t.observe(RExp(1.0).sample(rng, n) * slow)
    rates = t.port.worker_rates()
    np.testing.assert_array_equal(rates, t.ref.worker_rates())
    assert np.isclose(rates.mean(), 1.0) and rates[2] == rates.min()
    assert rates[2] < 0.3 * np.median(rates)
    t.replan()
    assert t.port.last_plan.planner == "heterogeneous"
    assert t.port.last_plan.spec.rates is not None


def test_observe_tagged_and_rates_for():
    t = Twin(RPlan(4, 2), RT.TunerConfig(min_samples=4, cooldown_steps=0))
    rng = np.random.default_rng(2)
    assert t.port.rates_for([0, 1]) is None
    for _ in range(6):
        ids = rng.choice(6, size=3, replace=False)
        times = rng.exponential(1.0, 3)
        times[0] = np.inf
        t.feed("observe_tagged", ids, times, rng.random(3) < 0.3)
    for ids in ([0, 1, 2], [3, 4, 5], [0, 5]):
        a, b = t.ref.rates_for(ids), t.port.rates_for(ids)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t.port.observe_tagged([1, 2], [1.0])


# -- tests/test_empirical.py: the goodness-of-fit gate ------------------------


def test_gate_keeps_parametric_path_on_well_specified_telemetry():
    t = Twin(RPlan(16, 16), RT.TunerConfig(min_samples=64, cooldown_steps=0,
                                           gof_alpha=0.01))
    _feed(t, RExp(1.0), 16, 20, np.random.default_rng(0))
    p = t.replan()
    assert not t.port.last_gof.rejected
    assert t.port.last_plan.planner == "analytic"
    assert p is not None and p.new_batches == 1


def test_gate_trips_on_heavy_tailed_step_time_telemetry():
    heavy = REmp(tuple(np.random.default_rng(1).lognormal(0.0, 1.2, 8_000)))
    sim = RS.StepTimeSimulator(heavy, 16, seed=2)
    t = Twin(RPlan(16, 16), RT.TunerConfig(
        min_samples=64, cooldown_steps=0, gof_alpha=0.01, sim_trials=2_000,
        bootstrap_resamples=8))
    for _ in range(20):
        t.observe(sim.next_step())
    t.replan()
    assert t.port.last_gof.rejected
    assert t.port.last_plan.planner == "empirical"
    assert isinstance(t.port.last_plan.spec.dist, TEmp)


def test_gate_handles_censored_telemetry_both_directions():
    rng = np.random.default_rng(3)

    def censor(draws):
        cut = np.quantile(draws, 0.75)
        return np.minimum(draws, cut), draws > cut

    ok = Twin(RPlan(16, 16), RT.TunerConfig(min_samples=64, cooldown_steps=0,
                                            gof_alpha=0.01))
    for _ in range(64):
        ok.observe(*censor(RExp(1.0).sample(rng, 16)))
    ok.replan()
    assert not ok.port.last_gof.rejected
    bad = Twin(RPlan(16, 16), RT.TunerConfig(
        min_samples=64, cooldown_steps=0, gof_alpha=0.01, sim_trials=2_000,
        bootstrap_resamples=8))
    for _ in range(64):
        bad.observe(*censor(rng.lognormal(0.0, 1.5, 16)))
    bad.replan()
    assert bad.port.last_gof.rejected
    assert bad.port.last_plan.planner == "empirical"
    x, c = bad.port.window_observations()
    assert set(bad.port.last_plan.spec.dist.atoms) <= set(x[~c])


def test_gate_off_by_default_and_empirical_primary_mode():
    rng = np.random.default_rng(4)
    off = Twin(RPlan(8, 8), RT.TunerConfig(min_samples=32, cooldown_steps=0))
    for _ in range(10):
        off.observe(rng.lognormal(0.0, 1.2, 8))
    off.replan()
    assert off.port.last_gof is None
    assert off.port.last_plan.planner == "analytic"
    primary = Twin(RPlan(8, 8), RT.TunerConfig(
        min_samples=32, cooldown_steps=0, mode="empirical", sim_trials=1_000,
        bootstrap_resamples=6))
    for _ in range(10):
        primary.observe(rng.lognormal(0.0, 1.2, 8))
    primary.replan()
    assert primary.port.last_gof is None
    assert primary.port.last_plan.planner == "empirical"


@pytest.mark.parametrize("n_slow", [0, 32])
def test_gate_on_censored_fleet_telemetry(n_slow):
    """chip_smoke.py's tuner_fleet telemetry without its drift: N 1,024 at
    B 256 (r 4), SExp(0.05, 2.0), per-unit times censored at each batch's
    first response.  The port's fit and KS verdict equal the reference's
    window by window; a well-specified fleet passes the first window and
    is rejected by the tenth, and with 32 workers slowed 4x the first
    window is rejected: the gate's empirical fallback carries the tuner
    at this scale."""
    from repro.core.estimator import fit_best as r_fit
    from repro.core.estimator import goodness_of_fit as r_gof
    from repro_torch.core.estimator import fit_best, goodness_of_fit

    n, b = 1024, 256
    sim = RS.StepTimeSimulator(RSExp(0.05, 2.0), n, seed=0, slow_workers={
        w: 4.0 for w in range(n_slow)})
    layout = r_layout(n, b)
    loads = np.full(n, n / b)
    xs, cs, verdicts = [], [], []
    for step in range(10):
        times = sim.next_step(loads)
        _, used = RS.completion_from_step_times(times, layout)
        obs, cens = RS.censored_observations(times, layout, used)
        xs.append(obs / loads)
        cs.append(cens)
        if step in (0, 9):
            x, c = np.concatenate(xs), np.concatenate(cs)
            ref = r_gof(x, r_fit(x, c).dist, c, alpha=0.01)
            port = goodness_of_fit(x, fit_best(x, c).dist, c, alpha=0.01)
            assert (port.statistic, port.threshold, port.rejected) == (
                ref.statistic, ref.threshold, ref.rejected)
            verdicts.append((round(port.statistic, 4),
                             round(port.threshold, 4), port.rejected))
    assert verdicts == {
        0: [(0.0716, 0.1017, False), (0.057, 0.0322, True)],
        32: [(0.1096, 0.1017, True), (0.0404, 0.0322, True)]}[n_slow]


# -- tests/test_queueing.py --------------------------------------------------


def test_tuner_objective_carries_speculation_triggers():
    t = Twin(RPlan(8, 4), RT.TunerConfig(mode="simulate"),
             speculation_quantiles=(0.8,))
    assert t.port.objective().speculation_quantiles is None
    t.feed("observe_load", 3.0)
    assert t.port.objective() == from_reference(t.ref.objective())
    assert t.port.objective().speculation_quantiles == (0.8,)


def test_tuner_miss_rate_breach_waives_hysteresis():
    rng = np.random.default_rng(0)

    def fresh():
        t = Twin(RPlan(16, 16), RT.TunerConfig(
            min_samples=16, cooldown_steps=0, improvement_threshold=0.95,
            miss_rate_target=0.05))
        _feed(t, RExp(2.0), 16, 4, rng)
        return t

    assert fresh().replan() is None  # the win is under the threshold
    breached = fresh()
    breached.feed("observe_deadline_misses", 10, 100)
    assert breached.port.observed_miss_rate == pytest.approx(0.10)
    p = breached.replan()
    assert p is not None and p.new_batches != 16
    assert breached.port.observed_miss_rate is None  # cleared on apply


def test_tuner_observe_load_and_sojourn_windows():
    t = Twin(RPlan(8, 4), RT.TunerConfig(min_samples=8, cooldown_steps=0,
                                         mode="simulate"))
    assert t.port.observed_arrival_rate is None
    for rate in (2.0, 4.0, math.inf):
        t.feed("observe_load", rate)
    assert t.port.observed_arrival_rate == t.ref.observed_arrival_rate == 3.0
    assert t.port.observed_sojourn("p99") is None
    t.feed("observe_sojourn", np.linspace(1.0, 2.0, 100))
    for m in ("mean", "var", "p99", "p999"):
        assert t.port.observed_sojourn(m) == t.ref.observed_sojourn(m)
    assert t.port.objective().arrival_rate == 3.0
    analytic = TT.StragglerTuner(TT.ReplicationPlan(8, 4), TT.TunerConfig())
    analytic.observe_load(2.0)
    assert not analytic.objective().load_aware


def test_forced_move_bypasses_observed_sojourn_hysteresis():
    rng = np.random.default_rng(0)
    t = Twin(RPlan(12, 3), RT.TunerConfig(
        min_samples=16, cooldown_steps=0, mode="simulate",
        improvement_threshold=0.5, sim_trials=300), batch_divisor=8)
    t.feed("observe_load", 4.0)
    for _ in range(8):
        t.observe(RSExp(0.05, 2.0).sample(rng, 12))
        t.feed("observe_sojourn", np.full(8, 1e-6))
    p = t.replan()
    assert p is not None and p.new_batches in (1, 2, 4)


def test_load_aware_hysteresis_reads_observed_sojourns():
    """With a refilled sojourn window the observed quantile is a baseline
    of the hysteresis, and apply() clears it."""
    rng = np.random.default_rng(5)
    t = Twin(RPlan(8, 8), RT.TunerConfig(
        min_samples=16, cooldown_steps=0, mode="simulate", sim_trials=300,
        metric="p99", improvement_threshold=0.05))
    t.feed("observe_load", 3.0)
    for _ in range(10):
        t.observe(RSExp(0.05, 2.0).sample(rng, 8))
        t.feed("observe_sojourn", rng.exponential(2.0, 16))
    t.replan()
    assert t.port.last_plan is not None


# -- tests/test_straggler_policies.py and tests/test_multitenant.py ----------


def test_tuner_objective_carries_policy_portfolio():
    pols = (RPol("relaunch", quantile=0.9),)
    t = Twin(RPlan(8, 4), RT.TunerConfig(mode="simulate"),
             policy_candidates=pols,
             arrival_offsets=np.cumsum(np.full(32, 0.5)))
    t.feed("observe_load", 3.0)
    obj = t.port.objective()
    assert obj == from_reference(t.ref.objective())
    assert obj.policies == (TP.PolicyCandidate(), *from_reference(pols))
    assert obj.speculation_quantiles is None and len(obj.arrivals) == 32
    with pytest.raises(ValueError):
        TT.StragglerTuner(TT.ReplicationPlan(8, 4),
                          TT.TunerConfig(mode="simulate"),
                          policy_candidates=from_reference(pols),
                          speculation_quantiles=(0.9,))


def test_tuner_class_miss_windows_and_guards():
    def tuner(**kw):
        return TT.StragglerTuner(TT.ReplicationPlan(8, 4),
                                 TT.TunerConfig(window_steps=16), **kw)

    classes = from_reference(CLASSES)
    t = tuner(slo_classes=classes, serving_batch_size=4)
    t.observe_deadline_misses(1, 1, slo="premium")
    t.observe_deadline_misses(0, 1, slo="premium")
    t.observe_deadline_misses(0, 1, slo="batch")
    assert t.class_miss_rates() == {"premium": 0.5, "batch": 0.0}
    assert t.observed_miss_rate == pytest.approx(1 / 3)
    assert t._class_target_breached()
    t.apply(type("RP", (), {"new_batches": 4})())
    assert t.class_miss_rates() == {}
    with pytest.raises(ValueError, match="serving_batch_size"):
        tuner(slo_classes=classes)
    with pytest.raises(ValueError, match="only apply"):
        tuner(max_wait_candidates=(0.5,))
    with pytest.raises(ValueError, match="mutually"):
        tuner(slo_classes=classes, serving_batch_size=4,
              speculation_quantiles=(0.9,))
    with pytest.raises(ValueError, match="miss telemetry"):
        t.observe_deadline_misses(3, 2)


def test_tuner_objective_carries_serving_axes():
    t = Twin(RPlan(8, 4), RT.TunerConfig(window_steps=16),
             slo_classes=CLASSES, serving_batch_size=4,
             max_wait_candidates=(0.5, 2.0),
             shed_candidates=(RShed("cap", cap=16),),
             policy_candidates=(RPol(),))
    t.feed("observe_load", 3.0)
    from repro.core.planner import SimulatedPlanner as RSim

    obj = t.port.objective(TP.SimulatedPlanner(n_trials=100, seed=0))
    assert obj == from_reference(t.ref.objective(RSim(n_trials=100, seed=0)))
    assert obj.slo_classes == from_reference(CLASSES) and obj.batch_size == 4
    assert obj.max_waits == (0.5, 2.0)
    assert t.port.objective(TP.AnalyticPlanner()).slo_classes is None


# -- tests/test_sojourn_kernel.py: the re-plan time budget ------------------


@pytest.mark.parametrize("budget", [0.0, 1e9])
def test_tuner_replan_budget_waives_cooldown(budget):
    """A budget no plan meets keeps the cooldown; one every plan meets
    waives it from the second attempt on."""
    t = Twin(RPlan(8, 2), RT.TunerConfig(
        window_steps=50, min_samples=16, cooldown_steps=1000,
        replan_time_budget=budget))
    rng = np.random.default_rng(0)
    for _ in range(4):
        t.observe(rng.exponential(1.0, 8))
    t.replan(apply=False)
    first = t.port._last_attempt
    assert t.port.last_replan_seconds is not None
    t.observe(rng.exponential(1.0, 8))
    t.replan(apply=False)
    assert t.port._cooldown_waived() == t.ref._cooldown_waived() == (
        budget > 0)
    if budget > 0:
        assert t.port._last_attempt > first
    else:
        assert t.port._last_attempt == first


# -- the online policy switch and a small tuner_fleet ----------------------


def test_online_policy_switch_matches_reference():
    """benchmarks/bench_serving_latency.py's switch (N 16, Exp(2.0) for 24
    steps then SExp(0.5, 2.0) for 32, load 13.0, the six-policy portfolio,
    p99) at 600 trials: every attempt's plan and every move."""
    t = Twin(RPlan(16, 4), RT.TunerConfig(
        mode="simulate", sim_trials=600, sim_seed=0, min_samples=64,
        cooldown_steps=8, window_steps=16, improvement_threshold=0.05,
        metric="p99"), policy_candidates=SWITCH_POLS)
    rng = np.random.default_rng(0)
    kinds = []
    for dist, steps in ((RExp(2.0), 24), (RSExp(0.5, 2.0), 32)):
        for _ in range(steps):
            t.observe(dist.sample(rng, 16))
            t.feed("observe_load", 13.0)
            t.replan()
        kinds.append(t.port.last_plan.policy.kind)
    assert t.port.plan == from_reference(t.ref.plan)
    assert kinds[1] in ("clone", "hedged") and kinds[0] != kinds[1]


def test_small_tuner_fleet_matches_reference():
    """chip_smoke.py's tuner_fleet at 16 workers: a slow worker, a fault,
    and a drift at step 8 to a two-mode pool (80% of the mass near 0.1,
    20% near 2.0) that the gate rejects at step 12; the rate-aware planner
    re-plans while the gate accepts the fit, the empirical fallback when
    it rejects it."""
    n = 16
    sim = RS.StepTimeSimulator(RSExp(0.05, 2.0), n, seed=0,
                               slow_workers={0: 4.0},
                               faults=[RS.FaultEvent(9, 3, 6)])
    port_sim = TS.StepTimeSimulator(
        from_reference(RSExp(0.05, 2.0)), n, seed=0, slow_workers={0: 4.0},
        faults=[TS.FaultEvent(9, 3, 6)])
    rng = np.random.default_rng(1)
    pool = REmp(tuple(np.where(rng.random(500) < 0.8, 0.1, 2.0)
                      * rng.lognormal(0.0, 0.1, 500)))
    t = Twin(RPlan(n, 4), RT.TunerConfig(
        mode="simulate", heterogeneous=True, sim_trials=120, window_steps=8,
        cooldown_steps=3, metric="p99", gof_alpha=0.01,
        bootstrap_resamples=3),
        policy_candidates=(RPol("clone", quantile=0.9),
                           RPol("relaunch", quantile=0.9),
                           RPol("hedged", hedge_fraction=0.1)))
    rate = 0.7 * n / RSExp(0.05, 2.0).mean()
    planners = []
    for step in range(24):
        if step == 8:
            sim._dist, port_sim._dist = pool, from_reference(pool)
        layout = r_layout(n, t.ref.plan.n_batches)
        loads = np.full(n, n / t.ref.plan.n_batches)
        times = sim.next_step(loads)
        np.testing.assert_array_equal(times, port_sim.next_step(loads))
        _, used = RS.completion_from_step_times(times, layout)
        obs, cens = RS.censored_observations(times, layout, used)
        t.observe(obs / loads, cens)
        t.feed("observe_load", rate)
        attempt = t.port._last_attempt
        t.replan()
        if t.port._last_attempt != attempt:
            planners.append(t.port.last_plan.planner)
    assert planners[0] == "heterogeneous" and "empirical" in planners


def test_tuner_default_device_is_cuda():
    """The tuner's sweeps run on the card unless the config asks for the
    CPU: without one, a simulated re-plan raises."""
    cfg = TT.TunerConfig(mode="simulate", min_samples=8, cooldown_steps=0)
    assert cfg.device is None and cfg.planner().device is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    tuner = TT.StragglerTuner(TT.ReplicationPlan(4, 2), cfg)
    for _ in range(4):
        tuner.observe(np.array([1.0, 1.2, 0.8, 1.1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        tuner.maybe_replan()
