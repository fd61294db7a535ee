"""Sojourns of one placement, the rate-aware and bootstrap planners and
``make_planner``: the port against the reference.

(1) ``simulate_sojourn_policies`` / ``_quantiles`` / ``simulate_sojourn``
    (``device="cpu"``: one ``sojourn_cells`` call of the plain version)
    are bit-equal to the reference's ``simulate_sojourn_policies(...,
    backend="pallas")`` (interpret mode) over contiguous and rate-aware
    placements, skewed rates, a given arrival trace, an Empirical
    distribution, and portfolios with and without an alternate draw (the
    reference draws it lazily: the two must consume the same stream).
    Against the reference's float64 numpy lane (``simulate_sojourn``,
    ``simulate_sojourn_quantiles``) every float32 sample lies within
    ``_f32_tol``: 3/2 of a float32 spacing at the case's largest time, for
    each job the FIFO chain can carry an error through (an arrival cast, a
    service cast and a sum, each half a spacing), plus the same for the
    subtraction of the arrival.  One ``sweep_sojourn_policies`` over every
    B, each under its own placement, gives each B's cells bit for bit what
    its per-B call gives.
(2) ``HeterogeneousPlanner(device="cpu")`` makes the reference's plans:
    bit-equal to ``SimulatedPlanner`` at rates of ones, the placement the
    reference emits on clustered slow hosts, the rate-aware placement, the
    skewed shrink (``drop_slowest``), the skewed policy portfolio (one
    launch a B, bit-equal to the reference's ``pallas`` lane) and the
    legacy trigger axis (against the reference's numpy lane: the same
    decision, points within 2e-3 relative).
(3) ``EmpiricalPlanner(device="cpu")`` makes the reference's
    ``EmpiricalPlanner(backend="pallas")`` plans: votes, confidence,
    vote_share, the spectrum (1e-12 relative) and the coded race's vote,
    under batch completion, load-aware sojourn, triggers, a policy
    portfolio (one launch), skewed rates and coded candidates; and its
    refusals.

Reference sweeps start from an empty group-minima cache.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import math

import numpy as np
import pytest

from repro.core import planner as RP
from repro.core import simulator as RS
from repro.core.coding import CodingCandidate as RCode
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.order_stats import expected_completion_rates
from repro.core.policies import PolicyCandidate as RPol
from repro.core.policies import rate_aware_assignment as r_rate_aware
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.kernels.sojourn_sweep import kernel as SK

SEXP = RSExp(0.05, 2.0)
EMP = REmp(tuple(np.random.default_rng(5).gamma(2.0, 0.25, 800)))
POLS = (RPol(), RPol("clone", quantile=0.85), RPol("relaunch", quantile=0.9),
        RPol("hedged", hedge_fraction=0.3))
RATES12 = np.linspace(0.5, 1.5, 12)

def _clear():
    RS._GROUP_MIN_CACHE.clear()


def _f32_tol(samples_ref, n_jobs):
    eps = float(np.spacing(np.float32(np.max(samples_ref))))
    return 1.5 * (n_jobs + 1) * eps


def _points(points):
    return [(p.n_batches, p.replication, p.mean, p.var, p.p99, p.p999)
            for p in points]


def _points_close(ref, port, rel=1e-12):
    assert len(ref) == len(port)
    for a, b in zip(_points(ref), _points(port)):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            assert math.isclose(x, y, rel_tol=rel, abs_tol=0.0), (a, b)


def _same_plan(ref, port):
    assert port.n_batches == ref.n_batches
    assert port.policy == from_reference(ref.policy)
    assert port.speculation_quantile == ref.speculation_quantile
    assert port.coding == from_reference(ref.coding)
    assert port.assignment.worker_batch == ref.assignment.worker_batch
    assert port.closed_form_mean == ref.closed_form_mean
    assert port.confidence == ref.confidence
    assert port.vote_share == ref.vote_share
    assert port.planner == ref.planner
    _points_close(ref.spectrum.points, port.spectrum.points)
    _points_close((ref.predicted,), (port.predicted,))


# -- (1) sojourns of one placement ----------------------------------------------


PER_B = {
    "contiguous": dict(),
    "rate_aware_skewed": dict(rates=RATES12,
                              worker_batch=r_rate_aware(12, 4, RATES12)
                              .worker_batch),
    "rate_aware_uniform": dict(worker_batch=r_rate_aware(12, 4, RATES12)
                               .worker_batch),
    "trace": dict(arrivals=np.cumsum(np.full(50, 0.4))),
}


@pytest.mark.parametrize("case", sorted(PER_B))
@pytest.mark.parametrize("portfolio", ["four", "none_only"])
@pytest.mark.parametrize("dist", ["sexp", "empirical"])
def test_simulate_sojourn_policies_matches_pallas_lane(case, portfolio, dist):
    d = {"sexp": SEXP, "empirical": EMP}[dist]
    pols = POLS if portfolio == "four" else (RPol(),)
    kw = dict(n_jobs=240, seed=3, **PER_B[case])
    _clear()
    ref = RS.simulate_sojourn_policies(d, 12, 4, 2.0, pols, backend="pallas",
                                       **kw)
    port = TS.simulate_sojourn_policies(from_reference(d), 12, 4, 2.0,
                                        from_reference(pols), device="cpu",
                                        **kw)
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_per_b_entries_share_one_draw_set_and_one_launch(monkeypatch):
    calls = []
    orig = SK.sojourn_cells

    def counted(*a, **k):
        calls.append(tuple(a[1].shape))
        return orig(*a, **k)

    monkeypatch.setattr(SK, "sojourn_cells", counted)
    d = from_reference(SEXP)
    kw = dict(n_jobs=200, seed=4, rates=RATES12, device="cpu")
    q = TS.simulate_sojourn_quantiles(d, 12, 3, 2.0, (None, 0.8, 0.9), **kw)
    assert calls == [(1, 200, 3)]
    pols = TS.simulate_sojourn_policies(
        d, 12, 3, 2.0, (TS.PolicyCandidate("none"),
                        TS.PolicyCandidate("clone", 0.8),
                        TS.PolicyCandidate("clone", 0.9)), **kw)
    for a, b in zip(q, pols):
        np.testing.assert_array_equal(a, b)
    for qq, samples in zip((None, 0.8, 0.9), q):
        np.testing.assert_array_equal(
            TS.simulate_sojourn(d, 12, 3, 2.0, speculation_quantile=qq,
                                **kw).samples, samples)
    assert len(calls) == 5 and q[0].shape == (180,)


@pytest.mark.parametrize("quantiles", [(None,), (None, 0.8, 0.9)])
@pytest.mark.parametrize("skewed", [False, True])
def test_per_b_sojourns_within_float32_of_numpy_lane(quantiles, skewed):
    kw = dict(n_jobs=400, seed=3)
    if skewed:
        kw.update(rates=RATES12,
                  worker_batch=r_rate_aware(12, 4, RATES12).worker_batch)
    ref = RS.simulate_sojourn_quantiles(SEXP, 12, 4, 2.0, quantiles, **kw)
    port = TS.simulate_sojourn_quantiles(from_reference(SEXP), 12, 4, 2.0,
                                         quantiles, device="cpu", **kw)
    for a, b in zip(ref, port):
        tol = _f32_tol(np.concatenate([a, RS._resolve_arrivals(
            None, 400, 2.0, np.random.default_rng(3))]), 400)
        assert np.abs(a - b).max() <= tol
    one = RS.simulate_sojourn(SEXP, 12, 4, 2.0, **kw)
    tone = TS.simulate_sojourn(from_reference(SEXP), 12, 4, 2.0,
                               device="cpu", **kw)
    assert np.abs(one.samples - tone.samples).max() <= _f32_tol(
        one.samples, 400) + _f32_tol(np.asarray([800.0]), 400)


def test_per_b_entries_validate_like_the_reference():
    d = from_reference(SEXP)
    with pytest.raises(ValueError, match="must divide"):
        TS.simulate_sojourn(d, 12, 5, 1.0, device="cpu")
    with pytest.raises(ValueError, match="quantile"):
        TS.simulate_sojourn_quantiles(d, 12, 4, 1.0, (1.5,), device="cpu")
    with pytest.raises(ValueError, match="worker_batch shape"):
        TS.simulate_sojourn_policies(d, 12, 4, 1.0, (TS.PolicyCandidate(),),
                                     worker_batch=np.zeros(5, int),
                                     device="cpu")
    with pytest.raises(ValueError, match="arrival_rate"):
        TS.simulate_sojourn(d, 12, 4, 0.0, device="cpu")


# -- (2) HeterogeneousPlanner ------------------------------------------------------


def test_rates_of_ones_is_the_simulated_planner():
    dist = RSExp(0.25, 1.0)
    hom = RP.ClusterSpec(n_workers=16, dist=dist)
    ones = RP.ClusterSpec(n_workers=16, dist=dist, rates=(1.0,) * 16)
    obj = RP.Objective(metric="mean")
    s = TP.SimulatedPlanner(n_trials=4000, seed=4, device="cpu").plan(
        from_reference(hom), from_reference(obj))
    h = TP.HeterogeneousPlanner(n_trials=4000, seed=4, device="cpu").plan(
        from_reference(ones), from_reference(obj))
    assert h.n_batches == s.n_batches and h.assignment == s.assignment
    assert h.predicted == s.predicted and h.spectrum.points == s.spectrum.points
    assert h.planner == "heterogeneous" and h.backend == "cpu"
    _clear()
    ref = RP.HeterogeneousPlanner(n_trials=4000, seed=4,
                                  backend="pallas").plan(ones, obj)
    _same_plan(ref, h)


# tests/test_planner.py's skewed shrink: two crippled hosts, 3 and 11
SHRINK_RATES = tuple(float(r) for r in np.where(
    np.arange(16) == 3, 0.05,
    np.where(np.arange(16) == 11, 0.08, np.linspace(1.3, 0.7, 16))))

HETERO_CASES = {
    # tests/test_planner.py: clustered slow hosts, the emitted placement
    "clustered": (RP.ClusterSpec(n_workers=16, dist=RSExp(1.0, 1.0),
                                 rates=(0.12,) * 4 + (1.3,) * 12),
                  RP.Objective(metric="mean"), 20_000),
    # tests/test_planner.py: the rate-aware placement
    "rate_aware": (RP.ClusterSpec(
        n_workers=16, dist=RSExp(0.25, 1.0),
        rates=tuple(float(r) for r in np.random.default_rng(0)
                    .uniform(0.3, 2.0, 16))),
        RP.Objective(metric="p99"), 8_000),
    # the skewed shrink: drop the two slowest, re-plan the survivors
    "shrink": (RP.ClusterSpec(n_workers=16, dist=RExp(1.0),
                              rates=SHRINK_RATES).drop_slowest(2)[0],
               RP.Objective(metric="mean"), 8_000),
    # tests/test_sojourn_kernel.py: the skewed policy portfolio
    "skewed_policies": (RP.ClusterSpec(n_workers=12, dist=SEXP,
                                       rates=tuple(RATES12)),
                        RP.Objective(metric="p99", utilization=0.6,
                                     policies=POLS), 300),
}


@pytest.mark.parametrize("case", sorted(HETERO_CASES))
def test_heterogeneous_plan_matches_reference(case):
    spec, obj, trials = HETERO_CASES[case]
    _clear()
    ref = RP.HeterogeneousPlanner(n_trials=trials, seed=0,
                                  backend="pallas").plan(spec, obj)
    port = TP.HeterogeneousPlanner(n_trials=trials, seed=0,
                                   device="cpu").plan(
        from_reference(spec), from_reference(obj))
    _same_plan(ref, port)
    assert port.backend == "cpu"
    assert port.assignment == TP.rate_aware_assignment(
        spec.n_workers, port.n_batches, spec.rates)
    if case == "clustered":
        best = min(spec.feasible_batches(), key=lambda b: (
            expected_completion_rates(
                spec.dist, 16, r_rate_aware(16, b, spec.rates).worker_batch,
                spec.rates)))
        assert port.n_batches == best
        assert port.predicted.mean == pytest.approx(port.closed_form_mean,
                                                    rel=0.05)


def test_skewed_policy_path_is_one_launch_a_b(monkeypatch):
    calls = []
    orig = SK.sojourn_cells

    def counted(*a, **k):
        calls.append(tuple(a[1].shape))
        return orig(*a, **k)

    monkeypatch.setattr(SK, "sojourn_cells", counted)
    spec, obj, _ = HETERO_CASES["skewed_policies"]
    TP.HeterogeneousPlanner(n_trials=100, seed=0, device="cpu").plan(
        from_reference(spec), from_reference(obj))
    assert calls == [(1, 100, b) for b in spec.feasible_batches()]


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("dist", ["sexp", "empirical"])
def test_one_sweep_scores_each_placement_as_its_per_b_call(skewed, dist):
    # one sweep over every B, each under its own rate-aware placement, in
    # one padded launch: each B's cells are bit-equal to its per-B call
    # (one draw set and one launch a B), so the two differ in cost only
    d = from_reference({"sexp": SEXP, "empirical": EMP}[dist])
    splits = (1, 2, 3, 4, 6, 12)
    wbs = tuple(r_rate_aware(12, b, RATES12).worker_batch for b in splits)
    kw = dict(n_jobs=200, seed=2, rates=RATES12 if skewed else None,
              device="cpu")
    pols = from_reference(POLS)
    TS._GROUP_MIN_CACHE.clear()
    sweep = TS.sweep_sojourn_policies(d, 12, 2.0, pols, feasible_b=splits,
                                      worker_batches=wbs, **kw)
    for si, b in enumerate(splits):
        per_b = TS.simulate_sojourn_policies(d, 12, b, 2.0, pols,
                                             worker_batch=wbs[si], **kw)
        for pi, samples in enumerate(per_b):
            np.testing.assert_array_equal(sweep.samples[0, si, pi], samples)


def test_skewed_trigger_axis_within_float32_of_numpy_lane():
    spec = RP.ClusterSpec(n_workers=12, dist=SEXP, rates=tuple(RATES12))
    obj = RP.Objective(metric="p99", utilization=0.6,
                       speculation_quantiles=(0.8, 0.9))
    ref = RP.HeterogeneousPlanner(n_trials=400, seed=0).plan(spec, obj)
    port = TP.HeterogeneousPlanner(n_trials=400, seed=0, device="cpu").plan(
        from_reference(spec), from_reference(obj))
    assert port.n_batches == ref.n_batches
    assert port.speculation_quantile == ref.speculation_quantile
    _points_close(ref.spectrum.points, port.spectrum.points, rel=2e-3)


# -- (3) EmpiricalPlanner -------------------------------------------------------


def _pool(dist, n, seed):
    return REmp(tuple(dist.sample(np.random.default_rng(seed), n)))


CODES = tuple(RCode("mds", s, encode_overhead=0.002, decode_overhead=0.003)
              for s in (4, 8, 12))
EMPIRICAL_CASES = {
    # tests/test_empirical.py's votes-and-confidence case
    "votes": (RP.ClusterSpec(n_workers=16,
                             dist=_pool(RSExp(0.25, 1.0), 3_000, 0)),
              RP.Objective(metric="mean"), 4_000, 12),
    # a parametric spec through a synthetic pool
    "parametric": (RP.ClusterSpec(n_workers=16, dist=RExp(1.0)),
                   RP.Objective(metric="mean"), 2_000, 8),
    # load-aware with the legacy trigger axis
    "speculative": (RP.ClusterSpec(n_workers=8,
                                   dist=_pool(RSExp(0.5, 2.0), 1_500, 2)),
                    RP.Objective(metric="p99", utilization=0.7,
                                 speculation_quantiles=(0.9,)), 300, 5),
    "sojourn": (RP.ClusterSpec(n_workers=8,
                               dist=_pool(RSExp(0.5, 2.0), 1_500, 2)),
                RP.Objective(metric="p99", utilization=0.7), 300, 4),
    "policies": (RP.ClusterSpec(n_workers=8, dist=_pool(SEXP, 1_500, 3)),
                 RP.Objective(metric="p99", utilization=0.7,
                              policies=POLS), 250, 6),
    "skewed_policies": (RP.ClusterSpec(
        n_workers=8, dist=_pool(SEXP, 1_500, 3),
        rates=tuple(np.linspace(0.4, 1.6, 8))),
        RP.Objective(metric="p99", utilization=0.6, policies=POLS), 250, 4),
    "skewed_batch": (RP.ClusterSpec(
        n_workers=12, dist=_pool(RSExp(0.25, 1.0), 1_000, 4),
        rates=tuple(RATES12)), RP.Objective(metric="var"), 1_000, 5),
    # the coded race and its own vote (heavy tail: coding can win)
    "coded": (RP.ClusterSpec(n_workers=16, dist=_pool(SEXP, 2_000, 1)),
              RP.Objective(metric="mean", coding=CODES), 1_500, 6),
    "coded_sojourn": (RP.ClusterSpec(n_workers=16, dist=_pool(SEXP, 2_000, 1)),
                      RP.Objective(metric="p99", utilization=0.7,
                                   coding=CODES), 200, 4),
}


@pytest.mark.parametrize("case", sorted(EMPIRICAL_CASES))
def test_empirical_plan_matches_reference(case):
    spec, obj, trials, k = EMPIRICAL_CASES[case]
    kw = dict(n_trials=trials, seed=1, n_resamples=k)
    if case == "parametric":
        kw["pool_size"] = 2_000
    _clear()
    rp = RP.EmpiricalPlanner(backend="pallas", **kw)
    ref = rp.plan(spec, obj)
    tp = TP.EmpiricalPlanner(device="cpu", **kw)
    port = tp.plan(from_reference(spec), from_reference(obj))
    _same_plan(ref, port)
    assert tp._votes == rp._votes
    assert tp._resample_best == rp._resample_best
    assert getattr(tp, "_coding_votes", None) == getattr(
        rp, "_coding_votes", None)
    assert port.backend == "cpu" and 0.0 < port.confidence <= 1.0
    shares = dict(port.vote_share)
    assert set(shares) == set(spec.feasible_batches())
    assert sum(shares.values()) == pytest.approx(1.0)
    if case == "parametric":
        assert port.n_batches == 1 and port.confidence == 1.0  # Thm 2


def test_empirical_policies_are_one_launch(monkeypatch):
    calls = []
    orig = SK.sojourn_cells

    def counted(*a, **k):
        calls.append((tuple(a[1].shape), int(a[3].shape[0])))
        return orig(*a, **k)

    monkeypatch.setattr(SK, "sojourn_cells", counted)
    spec, obj, _, k = EMPIRICAL_CASES["policies"]
    TP.EmpiricalPlanner(n_trials=60, seed=1, n_resamples=k,
                        device="cpu").plan(from_reference(spec),
                                           from_reference(obj))
    n_b = len(spec.feasible_batches())
    assert calls == [((k * n_b, 60, max(spec.feasible_batches())), 4)]


def test_empirical_planner_refusals():
    spec = from_reference(EMPIRICAL_CASES["votes"][0])
    with pytest.raises(ValueError, match="slo_classes"):
        TP.EmpiricalPlanner(device="cpu").plan(spec, TP.Objective(
            metric="p99", utilization=0.5, batch_size=4,
            slo_classes=(TP.SloClass("premium", deadline=1.0,
                                     miss_target=0.1),)))
    skewed = from_reference(EMPIRICAL_CASES["skewed_batch"][0])
    with pytest.raises(ValueError, match="speculation_quantiles"):
        TP.EmpiricalPlanner(device="cpu").plan(skewed, TP.Objective(
            metric="p99", utilization=0.5, speculation_quantiles=(0.9,)))
    with pytest.raises(ValueError, match="n_resamples"):
        TP.EmpiricalPlanner(n_resamples=0, device="cpu").plan(spec)


# -- (4) make_planner ----------------------------------------------------------


def test_make_planner_maps_every_mode():
    het = TP.make_planner("simulate", heterogeneous=True, n_trials=123,
                          device="cpu")
    assert isinstance(het, TP.HeterogeneousPlanner) and het.n_trials == 123
    emp = TP.make_planner("empirical", n_trials=500, seed=7, n_resamples=9,
                          device="cpu")
    assert isinstance(emp, TP.EmpiricalPlanner)
    assert (emp.n_trials, emp.seed, emp.n_resamples) == (500, 7, 9)
    assert isinstance(TP.make_planner("empirical", heterogeneous=True),
                      TP.EmpiricalPlanner)
    assert TP.make_planner("simulate").name == "simulated"
    with pytest.raises(ValueError):
        TP.make_planner("analytic", heterogeneous=True)
    with pytest.raises(ValueError):
        TP.make_planner("newton")
    plan = dataclasses.replace(emp, n_trials=300, n_resamples=3).plan(
        from_reference(EMPIRICAL_CASES["votes"][0]))
    assert plan.planner == "empirical" and plan.backend == "cpu"
