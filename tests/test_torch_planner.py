"""The slice as a whole: the port's planner against the reference's.

``SimulatedPlanner(device="cpu").plan()`` of the port and
``SimulatedPlanner(backend="pallas").plan()`` of the reference make the
same decision (``n_batches``, ``policy``, ``speculation_quantile``,
``coding``) with spectrum points equal within 1e-12 relative, on

(a) the p99, utilization=0.7, four-policy objective;
(b) the mean objective with mds s in {4, 8, 12} and explicit overheads
    (the heavy-tail fleet of ``benchmarks/bench_coding.py``, fewer trials);
(c) a batch-completion (not load-aware) var objective;

plus the speculative-trigger objective and the closed-form planner.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import math

import numpy as np
import pytest
import torch

from repro.core import planner as RP
from repro.core.coding import CodingCandidate as RCode
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import PolicyCandidate as RPol
from repro.core.policies import SloClass as RSlo
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP

HEAVY = RSExp(0.05, 2.0)
POLICIES = (RPol("none"), RPol("clone", quantile=0.85),
            RPol("relaunch", quantile=0.9), RPol("hedged", hedge_fraction=0.3))
CODES = tuple(RCode("mds", s, encode_overhead=0.002, decode_overhead=0.003)
              for s in (4, 8, 12))

CASES = {
    "p99_policies": (RP.ClusterSpec(n_workers=16, dist=HEAVY,
                                    feasible_b=(2, 4, 8)),
                     RP.Objective(metric="p99", utilization=0.7,
                                  policies=POLICIES), 400),
    "mean_coded": (RP.ClusterSpec(n_workers=16, dist=HEAVY),
                   RP.Objective(metric="mean", coding=CODES), 1500),
    "var_batch": (RP.ClusterSpec(n_workers=16, dist=RExp(2.0)),
                  RP.Objective(metric="var"), 1500),
    "p99_speculative": (RP.ClusterSpec(n_workers=16, dist=HEAVY,
                                       feasible_b=(2, 4, 8)),
                        RP.Objective(metric="p99", utilization=0.7,
                                     speculation_quantiles=(0.8, 0.9)), 400),
    "p99_coded_sojourn": (RP.ClusterSpec(n_workers=16, dist=HEAVY,
                                         feasible_b=(2, 4, 8)),
                          RP.Objective(metric="p99", utilization=0.7,
                                       coding=CODES), 400),
}


def _points_close(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert (a.n_batches, a.replication) == (b.n_batches, b.replication)
        for f in ("mean", "var", "p99", "p999"):
            x, y = getattr(a, f), getattr(b, f)
            assert math.isclose(x, y, rel_tol=1e-12, abs_tol=0.0), (f, x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulated_plan_matches_reference(case):
    spec, obj, trials = CASES[case]
    ref = RP.SimulatedPlanner(n_trials=trials, seed=0,
                              backend="pallas").plan(spec, obj)
    port = TP.SimulatedPlanner(n_trials=trials, seed=0, device="cpu").plan(
        from_reference(spec), from_reference(obj))
    assert port.n_batches == ref.n_batches
    assert port.policy == from_reference(ref.policy)
    assert port.speculation_quantile == ref.speculation_quantile
    assert port.coding == from_reference(ref.coding)
    assert port.backend == "cpu"
    assert port.planner == ref.planner == "simulated"
    assert port.assignment.worker_batch == ref.assignment.worker_batch
    _points_close(ref.spectrum.points, port.spectrum.points)
    _points_close((ref.predicted,), (port.predicted,))


def test_coded_heavy_tail_adopts_mds_s12():
    """The BENCH_coding headline at reduced trials: coding wins."""
    spec, obj, trials = CASES["mean_coded"]
    plan = TP.SimulatedPlanner(n_trials=trials, seed=0, device="cpu").plan(
        from_reference(spec), from_reference(obj))
    assert plan.coding is not None and plan.coding.describe() == "mds(s=12)"
    assert plan.policy is None and plan.speculation_quantile is None


def test_measured_overheads_are_resolved_on_cpu():
    spec = TP.ClusterSpec(n_workers=8, dist=from_reference(HEAVY))
    obj = TP.Objective(metric="mean",
                       coding=(from_reference(RCode("mds", 2)),))
    plan = TP.SimulatedPlanner(n_trials=300, seed=0, device="cpu").plan(
        spec, obj)
    best = plan.coding if plan.coding is not None else None
    if best is not None:
        assert best.resolved
    cands = TP.SimulatedPlanner(device="cpu")._resolved_coding(obj, 8, "cpu")
    assert all(c.resolved and c.encode_overhead >= 0.0 for c in cands)


@pytest.mark.parametrize("metric", ["mean", "var", "p99", "p999"])
def test_analytic_plan_equals_reference(metric):
    spec = RP.ClusterSpec(n_workers=24, dist=RSExp(0.1, 3.0))
    obj = RP.Objective(metric=metric)
    ref = RP.AnalyticPlanner().plan(spec, obj)
    port = TP.AnalyticPlanner().plan(from_reference(spec),
                                     from_reference(obj))
    assert port.n_batches == ref.n_batches and port.backend is None
    _points_close(ref.spectrum.points, port.spectrum.points)


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    spec, obj, _ = CASES["var_batch"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.SimulatedPlanner().plan(from_reference(spec), from_reference(obj))
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_planner("simulate", n_trials=50).plan(
            from_reference(spec), from_reference(obj))


def test_unported_modes_raise():
    """The modes this test once saw refused (the rate-aware and bootstrap
    planners) are ported: each now plans on the CPU."""
    skewed = from_reference(RP.ClusterSpec(
        n_workers=8, dist=HEAVY, rates=(0.2,) + (1.0,) * 7))
    het = TP.make_planner("simulate", heterogeneous=True, n_trials=300,
                          device="cpu")
    plan = het.plan(skewed, TP.Objective(metric="mean"))
    assert plan.planner == "heterogeneous" and plan.backend == "cpu"
    assert plan.n_batches in skewed.feasible_batches()
    emp = TP.make_planner("empirical", n_trials=300, device="cpu",
                          n_resamples=3)
    plan = emp.plan(skewed, TP.Objective(metric="mean"))
    assert plan.planner == "empirical" and 0.0 < plan.confidence <= 1.0
    assert TP.make_planner("analytic").name == "analytic"
    spec = from_reference(RP.ClusterSpec(n_workers=8, dist=HEAVY))
    obj = from_reference(RP.Objective(
        metric="p99", utilization=0.5, batch_size=4,
        slo_classes=(RSlo("premium", deadline=1.0, miss_target=0.1),)))
    # the serving sweep is ported: the objective that was refused now plans
    plan = TP.SimulatedPlanner(n_trials=400, device="cpu").plan(spec, obj)
    assert plan.shed is not None


def test_objective_load_accounting_equals_reference():
    spec = RP.ClusterSpec(n_workers=16, dist=HEAVY)
    obj = RP.Objective(metric="p99", utilization=0.7, policies=POLICIES)
    t_spec, t_obj = from_reference(spec), from_reference(obj)
    assert t_obj.offered_rate(t_spec) == obj.offered_rate(spec)
    for rp, tp in zip(obj.policies, t_obj.policies):
        assert t_obj.offered_rate(t_spec, tp) == obj.offered_rate(spec, rp)
        assert (t_obj.charged_utilization(t_spec, tp)
                == obj.charged_utilization(spec, rp))
    assert t_spec.feasible_batches() == spec.feasible_batches()
    np.testing.assert_array_equal(
        np.asarray(t_spec.drop_slowest(3)[0].feasible_batches()),
        np.asarray(spec.drop_slowest(3)[0].feasible_batches()))
