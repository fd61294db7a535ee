"""The multi-tenant serving sweep and the planner's serving branch, port
against reference.

(1) ``_form_schedule``, the WFQ formation pre-pass, is bit-equal to the
    reference's for every shed kind, finite and infinite max_wait, one
    class and two; a hand trace pins cap eviction (a heavier class evicts
    the newest cheapest request, equal weights never evict).
(2) ``sweep_sojourn_serving(device="cpu")`` is bit-equal to the
    reference's ``backend="pallas"`` lane (``req_job``, every ``formed``
    and ``samples`` cell, ``extra_fraction``) on
    ``tests/test_multitenant.py``'s ``SWEEP_KW`` at 600 requests and
    B in {2, 4}, with the given trace too.
(3) Every sweep cell is bit-equal to the port's
    ``simulate_sojourn_serving``; against the reference's float64 numpy
    standalone, ``req_job`` is equal and served latency's mean and p99
    agree within 2e-3 and 5e-3 relative (the reference's own tolerances
    for its float32 lanes).
(4) ``SimulatedPlanner(device="cpu").plan`` makes the reference's
    BENCH_multitenant decision, in 21 scans; at
    ``test_simulated_planner_serving_plan_lands_full_cell``'s size every
    spectrum point and the class report are bit-equal to the reference's
    ``pallas`` lane.
(5) The reference's errors.

Reference sweeps start from an empty group-minima cache: the reference
keys it without the class labels' origin (ROADMAP §C, pinned by
``test_reference_cache_key_ignores_given_labels``), so a stale entry from
another test in the same process could leak into its draws.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import planner as RP
from repro.core import simulator as RS
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import PolicyCandidate as RPol
from repro.core.policies import ShedPolicy as RShed
from repro.core.policies import SloClass as RSlo
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.kernels.sojourn_sweep import kernel as SK

CLASSES = (
    RSlo("premium", share=0.3, weight=4.0, deadline=0.8, miss_target=0.05),
    RSlo("batch", share=0.7, weight=1.0),
)
# tests/test_multitenant.py's SWEEP_KW at 600 requests
SWEEP_KW = dict(
    n_workers=8, request_rate=9.0, batch_size=4, slo_classes=CLASSES,
    policies=(RPol(), RPol("hedged", hedge_fraction=1.0)),
    max_waits=(0.3, math.inf), sheds=(RShed(), RShed("cap", cap=24)),
    n_requests=600, seed=7, feasible_b=(2, 4), job_load=0.5,
)
R_DISTS = (RSExp(0.05, 2.0), RExp(2.0))

# benchmarks/bench_multitenant.py's swept engine, as its planner sees it:
# 16 groups, SExp(0.02, 2.0), utilization 0.95, job_load 0.96, batch 4
BENCH_CLASSES = (
    RSlo("premium", share=0.25, weight=4.0, deadline=0.8, miss_target=0.05),
    RSlo("standard", share=0.75, weight=1.0, deadline=3.0, miss_target=0.5),
)
BENCH_SPEC = RP.ClusterSpec(n_workers=16, dist=RSExp(0.02, 2.0))
BENCH_OBJ = RP.Objective(
    metric="mean", utilization=0.95, job_load=0.96, batch_size=4,
    slo_classes=BENCH_CLASSES,
    policies=(RPol(), RPol("hedged", hedge_fraction=1.0)),
    max_waits=(0.2, 0.5, math.inf),
    sheds=(RShed("cap", cap=48), RShed("expired")),
)


def _port_kw(kw):
    return {k: v if isinstance(v, np.ndarray) else from_reference(v)
            for k, v in kw.items()}


def _ref_sweep(dists, **kw):
    RS._GROUP_MIN_CACHE.clear()
    return RS.sweep_sojourn_serving(dists, backend="pallas", **kw)


def _same_sweep(ref, port):
    assert port.backend == "cpu"
    assert (port.splits, port.max_waits, port.warmup) == (
        ref.splits, ref.max_waits, ref.warmup)
    np.testing.assert_array_equal(port.request_arrivals, ref.request_arrivals)
    np.testing.assert_array_equal(port.request_class, ref.request_class)
    np.testing.assert_array_equal(port.deadlines, ref.deadlines)
    np.testing.assert_array_equal(port.req_job, ref.req_job)
    np.testing.assert_array_equal(port.extra_fraction, ref.extra_fraction)
    for di in range(len(ref.dists)):
        for si in range(len(ref.splits)):
            for wi in range(len(ref.max_waits)):
                for hi in range(len(ref.sheds)):
                    np.testing.assert_array_equal(
                        port.formed[di][si][wi][hi], ref.formed[di][si][wi][hi])
                    np.testing.assert_array_equal(
                        port.samples[di][si][wi][hi],
                        ref.samples[di][si][wi][hi])


# -- (1) the formation pre-pass ----------------------------------------------

def _trace(n_classes, seed=11, n=400, rate=12.0):
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.standard_exponential(n)) / rate
    cls = rng.integers(0, n_classes, n).astype(np.int64)
    rel = np.array([0.2, 2.0][:n_classes])
    return arrivals, cls, arrivals + rel[cls]


FORM_SHEDS = {
    "none": (RShed(), None),
    "expired": (RShed("expired"), None),
    "cap": (RShed("cap", cap=6), 2.5),
}


CLASS_WEIGHTS = {"one": (1.0,), "two_equal": (1.0, 1.0),
                 "two_heavier": (4.0, 1.0)}


@pytest.mark.parametrize("classes", sorted(CLASS_WEIGHTS))
@pytest.mark.parametrize("max_wait", [0.3, math.inf])
@pytest.mark.parametrize("shed", sorted(FORM_SHEDS))
def test_form_schedule_bit_equal(shed, max_wait, classes):
    weights = np.asarray(CLASS_WEIGHTS[classes])
    arrivals, cls, deadlines = _trace(len(weights))
    names = ("gold", "econ")[:len(weights)]
    policy, drain = FORM_SHEDS[shed]
    q_max = 4.0 if drain is not None else math.inf
    ref_formed, ref_rj = RS._form_schedule(
        arrivals, cls, names, weights, 4, max_wait, policy, deadlines, drain,
        q_max)
    formed, rj = TS._form_schedule(
        arrivals, cls, names, weights, 4, max_wait, from_reference(policy),
        deadlines, drain, q_max)
    np.testing.assert_array_equal(formed, ref_formed)
    np.testing.assert_array_equal(rj, ref_rj)
    assert rj.dtype == np.int64 and np.all(np.diff(formed) >= 0)
    if shed == "none":
        assert np.all(rj >= 0)
    else:
        assert np.any(rj < 0)  # the trace is made to shed


@pytest.mark.parametrize("weights,served", [
    ((1.0, 1.0), [0, 0, -1]),  # equal weights: the arrival is shed
    ((1.0, 4.0), [0, -1, 0]),  # heavier arrival evicts the newest light one
])
def test_form_schedule_cap_eviction(weights, served):
    arrivals = np.array([0.0, 1.0, 2.0])
    cls = np.array([0, 0, 1], dtype=np.int64)
    args = (arrivals, cls, ("econ", "gold"), np.asarray(weights), 4,
            math.inf)
    for mod, shed in ((TS, TP.ShedPolicy("cap", cap=2)),
                      (RS, RShed("cap", cap=2))):
        formed, rj = mod._form_schedule(*args, shed, arrivals + 10.0, 0.5,
                                        8.0)
        np.testing.assert_array_equal(rj >= 0, np.asarray(served) >= 0)
        np.testing.assert_array_equal(formed, [2.0])


# -- (2) the sweep against the reference's pallas lane -----------------------

@pytest.mark.parametrize("policies", [
    SWEEP_KW["policies"],
    (RPol(), RPol("clone", quantile=0.85), RPol("relaunch", quantile=0.9)),
], ids=["none_hedged", "triggers"])
def test_sweep_bit_equal_to_reference(policies):
    kw = dict(SWEEP_KW, policies=policies)
    ref = _ref_sweep(R_DISTS, **kw)
    port = TS.sweep_sojourn_serving(from_reference(R_DISTS), **_port_kw(kw),
                                    device="cpu")
    _same_sweep(ref, port)
    assert ref.req_job.shape == (2, 2, 2, 2, 600)


def test_sweep_replays_a_given_trace_bit_equal():
    rng = np.random.default_rng(4)
    arrivals = np.cumsum(rng.standard_exponential(600)) / 9.0
    labels = rng.choice(["premium", "batch"], 600, p=[0.3, 0.7]).tolist()
    kw = dict(SWEEP_KW, arrivals=arrivals, class_labels=labels)
    # first the sweep's first combo on the same arrivals with drawn labels:
    # its draws come later in the stream, so the group minima it leaves in
    # the cache (same splits, same job count) must not be reused
    TS.sweep_sojourn_serving(
        from_reference(R_DISTS[0]), **_port_kw(dict(
            SWEEP_KW, arrivals=arrivals, max_waits=SWEEP_KW["max_waits"][:1],
            sheds=SWEEP_KW["sheds"][:1])), device="cpu")
    port = TS.sweep_sojourn_serving(from_reference(R_DISTS[0]),
                                    **_port_kw(kw), device="cpu")
    ref = _ref_sweep(R_DISTS[0], **kw)
    _same_sweep(ref, port)
    np.testing.assert_array_equal(port.request_arrivals, arrivals)


def test_reference_cache_key_ignores_given_labels():
    """The reference's defect (ROADMAP §C): its group-minima key omits
    whether the class labels were given, so after a sweep with drawn
    labels a sweep with given labels reuses the other draws' minima.  The
    port keys on it and matches a clean reference run."""
    rng = np.random.default_rng(4)
    arrivals = np.cumsum(rng.standard_exponential(600)) / 9.0
    labels = rng.choice(["premium", "batch"], 600, p=[0.3, 0.7]).tolist()
    first = dict(SWEEP_KW, arrivals=arrivals, max_waits=(0.3,),
                 sheds=(RShed(),))
    kw = dict(SWEEP_KW, arrivals=arrivals, class_labels=labels)
    RS._GROUP_MIN_CACHE.clear()
    RS.sweep_sojourn_serving(R_DISTS[0], backend="pallas", **first)
    stale = RS.sweep_sojourn_serving(R_DISTS[0], backend="pallas", **kw)
    clean = _ref_sweep(R_DISTS[0], **kw)
    TS.sweep_sojourn_serving(from_reference(R_DISTS[0]), **_port_kw(first),
                             device="cpu")
    port = TS.sweep_sojourn_serving(from_reference(R_DISTS[0]),
                                    **_port_kw(kw), device="cpu")
    np.testing.assert_array_equal(stale.req_job, clean.req_job)
    cell = (stale.samples[0][0][0][0], clean.samples[0][0][0][0])
    assert cell[0].shape == (2, 193)
    assert np.all(cell[0] != cell[1])
    _same_sweep(clean, port)


def test_sweep_without_jobs_makes_no_scan(monkeypatch):
    calls = []
    orig = SK.sojourn_cells

    def counted(*a, **k):
        calls.append(a[1].shape)
        return orig(*a, **k)

    monkeypatch.setattr(SK, "sojourn_cells", counted)
    # requests 10 apart, deadline 0.5, max_wait 1: every one expires in
    # its own queue before its timer forms it
    kw = dict(SWEEP_KW, arrivals=np.arange(50) * 10.0, n_requests=50,
              slo_classes=(RSlo("only", deadline=0.5),),
              max_waits=(1.0,), sheds=(RShed("expired"),))
    port = TS.sweep_sojourn_serving(from_reference(R_DISTS[0]),
                                    **_port_kw(kw), device="cpu")
    ref = _ref_sweep(R_DISTS[0], **kw)
    assert calls == []
    assert np.all(port.req_job < 0)
    _same_sweep(ref, port)
    assert port.samples[0][0][0][0].shape == (2, 0)


# -- (3) sweep cells against the standalone replay ---------------------------

def test_sweep_cells_bit_equal_standalone_and_near_reference_numpy():
    dist = R_DISTS[0]
    port = TS.sweep_sojourn_serving(from_reference(dist),
                                    **_port_kw(SWEEP_KW), device="cpu")
    knobs = dict(n_requests=SWEEP_KW["n_requests"], seed=SWEEP_KW["seed"],
                 job_load=SWEEP_KW["job_load"])
    for si, b in enumerate(port.splits):
        for pi, pol in enumerate(SWEEP_KW["policies"]):
            for wi, mw in enumerate(port.max_waits):
                for hi, shed in enumerate(SWEEP_KW["sheds"]):
                    args = (8, b, SWEEP_KW["request_rate"], 4)
                    sim = TS.simulate_sojourn_serving(
                        from_reference(dist), *args, from_reference(CLASSES),
                        from_reference(pol), max_wait=mw,
                        shed=from_reference(shed), device="cpu", **knobs)
                    lat = port.request_latency(0, si, pi, wi, hi)
                    np.testing.assert_array_equal(lat, sim.latency)
                    np.testing.assert_array_equal(
                        sim.extra_fraction,
                        port.extra_fraction[0, si, pi, wi, hi])
                    ref = RS.simulate_sojourn_serving(
                        dist, *args, CLASSES, pol, max_wait=mw, shed=shed,
                        **knobs)
                    np.testing.assert_array_equal(sim.req_job, ref.req_job)
                    np.testing.assert_array_equal(sim.formed, ref.formed)
                    a = ref.latency[~np.isnan(ref.latency)]
                    c = sim.latency[~np.isnan(sim.latency)]
                    assert c.mean() == pytest.approx(a.mean(), rel=2e-3)
                    assert np.quantile(c, 0.99) == pytest.approx(
                        np.quantile(a, 0.99), rel=5e-3)


# -- (4) the planner's serving branch ----------------------------------------

# RS.SimulatedPlanner(n_trials=4000, seed=0).plan(BENCH_SPEC, BENCH_OBJ)'s
# decision, numpy lane (the pallas lane makes the same)
BENCH_DECISION = dict(n_batches=2, max_wait=math.inf, shed=("cap", 48),
                      policy="none",
                      class_report=(("premium", 0.0),
                                    ("standard", 0.3334582240539528)))


def test_plan_serving_makes_the_bench_multitenant_decision(monkeypatch):
    calls = []
    orig = SK.sojourn_cells

    def counted(*a, **k):
        calls.append(tuple(a[1].shape))
        return orig(*a, **k)

    monkeypatch.setattr(SK, "sojourn_cells", counted)
    plan = TP.SimulatedPlanner(n_trials=4000, seed=0, device="cpu").plan(
        from_reference(BENCH_SPEC), from_reference(BENCH_OBJ))
    ref = RP.SimulatedPlanner(n_trials=4000, seed=0).plan(BENCH_SPEC,
                                                          BENCH_OBJ)
    for p in (plan, ref):
        assert p.n_batches == BENCH_DECISION["n_batches"]
        assert p.max_wait == BENCH_DECISION["max_wait"]
        assert (p.shed.kind, p.shed.cap) == BENCH_DECISION["shed"]
        assert p.policy.kind == BENCH_DECISION["policy"]
        assert p.class_report == BENCH_DECISION["class_report"]
    assert plan.backend == "cpu"
    # 3 max_waits x (none, expired) one scan each, 3 x 5 splits under cap
    assert len(calls) == 3 * 2 + 3 * 5
    assert sorted({c[0] for c in calls}) == [1, 5]


def test_plan_serving_bit_equal_to_reference_pallas():
    spec = RP.ClusterSpec(n_workers=8, dist=RSExp(delta=0.02, mu=2.0))
    obj = RP.Objective(
        utilization=0.85, batch_size=4, slo_classes=CLASSES, job_load=0.5,
        max_waits=(0.3, 2.0), sheds=(RShed("cap", cap=24),),
        policies=(RPol(),),
    )
    RS._GROUP_MIN_CACHE.clear()
    ref = RP.SimulatedPlanner(n_trials=1500, seed=1,
                              backend="pallas").plan(spec, obj)
    port = TP.SimulatedPlanner(n_trials=1500, seed=1, device="cpu").plan(
        from_reference(spec), from_reference(obj))
    assert (port.n_batches, port.max_wait, port.shed.kind, port.policy.kind) \
        == (ref.n_batches, ref.max_wait, ref.shed.kind, ref.policy.kind)
    assert port.class_report[0] == ref.class_report[0]
    assert port.class_report[1][0] == "batch"
    assert math.isnan(port.class_report[1][1])
    assert math.isnan(ref.class_report[1][1])
    for a, b in zip(ref.spectrum.points, port.spectrum.points):
        assert (a.n_batches, a.mean, a.var, a.p99, a.p999) == (
            b.n_batches, b.mean, b.var, b.p99, b.p999)
    assert port.predicted == port.spectrum.at(port.n_batches)
    assert port.assignment is not None


# -- (5) errors --------------------------------------------------------------

def test_serving_errors_match_the_reference():
    kw = _port_kw(SWEEP_KW)
    emp = REmp(np.random.default_rng(0).exponential(0.5, 64))
    with pytest.raises(TypeError, match="mu-exposing"):
        RS.sweep_sojourn_serving(emp, **SWEEP_KW)
    with pytest.raises(TypeError, match="mu-exposing"):
        TS.sweep_sojourn_serving(from_reference(emp), **kw, device="cpu")
    dup = (RSlo("a"), RSlo("a"))
    with pytest.raises(ValueError, match="duplicate"):
        RS.sweep_sojourn_serving(R_DISTS[0], **dict(SWEEP_KW,
                                                    slo_classes=dup))
    with pytest.raises(ValueError, match="duplicate"):
        TS.sweep_sojourn_serving(from_reference(R_DISTS[0]),
                                 **dict(kw, slo_classes=from_reference(dup)),
                                 device="cpu")
    with pytest.raises(ValueError, match="infeasible"):
        TS.simulate_sojourn_serving(
            from_reference(R_DISTS[0]), 8, 3, 9.0, 4, from_reference(CLASSES),
            TP.PolicyCandidate(), device="cpu")
    skewed = RP.ClusterSpec(n_workers=8, dist=RSExp(0.02, 2.0),
                            rates=(1.0,) * 4 + (2.0,) * 4)
    obj = RP.Objective(utilization=0.5, batch_size=4, slo_classes=CLASSES)
    with pytest.raises(ValueError, match="rate-skewed"):
        RP.SimulatedPlanner(n_trials=200).plan(skewed, obj)
    with pytest.raises(ValueError, match="rate-skewed"):
        TP.SimulatedPlanner(n_trials=200, device="cpu").plan(
            from_reference(skewed), from_reference(obj))


def test_serving_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.sweep_sojourn_serving(from_reference(R_DISTS[0]),
                                 **_port_kw(SWEEP_KW))
