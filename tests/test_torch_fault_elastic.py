"""Fault tolerance and elastic rescaling: the port against the reference.

Mirrors ``tests/test_fault_elastic_data.py`` (the straggler detector, mask
against re-plan, the executor, the byte model) and
``tests/test_planner.py``'s elastic and recovery cases (shrink drops the
slowest, ``apply_plan``, recovery through the planner with survivor
rates), each run through both packages on the same inputs, the port on
``device="cpu"``: every decision, alive mask, lost batch, B, assignment,
dropped id and prediction equals the reference's.  The rate-aware
recoveries take the coverage rule, float64 in both packages, so the
spectra are equal bit for bit.  Then the rate-aware p99 ``plan_recovery``
on ``benchmarks/bench_planner.py``'s skewed N 64 fleet, the device rule,
and the sojourn seam's cell split over ``["cpu", "cpu"]`` on that fleet's
load-aware sweep, bit-equal to one device.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Exponential as RExp
from repro.core import HeterogeneousPlanner as RHetero
from repro.core import ReplicationPlan as RPlan
from repro.core import ShiftedExponential as RSExp
from repro.core.planner import ClusterSpec as RSpec
from repro.distributed import FaultManager as RFM
from repro.distributed import RescaleExecutor as RExec
from repro.distributed import RuntimeTopology as RTopo
from repro.distributed import StragglerDetector as RDet
from repro_torch.convert import from_reference
from repro_torch.core import Exponential as TExp
from repro_torch.core import HeterogeneousPlanner as THetero
from repro_torch.core import PolicyCandidate as TPol
from repro_torch.core import ReplicationPlan as TPlan
from repro_torch.core import ShiftedExponential as TSExp
from repro_torch.core import simulator as TS
from repro_torch.core.planner import ClusterSpec as TSpec
from repro_torch.distributed import FaultManager as TFM
from repro_torch.distributed import RescaleExecutor as TExec
from repro_torch.distributed import RuntimeTopology as TTopo
from repro_torch.distributed import StragglerDetector as TDet

CPU = "cpu"
# benchmarks/bench_planner.py's fleet: N 64, SExp(0.25, 1.0), one
# crippled host
BENCH_N = 64
BENCH_RATES = np.concatenate([[0.1], np.linspace(0.7, 1.3, BENCH_N - 1)])


def same_plan(port, ref):
    """The port's Plan makes the reference's decision, bit for bit."""
    assert port.planner == ref.planner
    assert port.replication == from_reference(ref.replication)
    assert port.assignment == from_reference(ref.assignment)
    assert port.spec.rates == ref.spec.rates
    assert port.spec.n_workers == ref.spec.n_workers
    assert np.array_equal(
        [dataclasses.astuple(p) for p in port.spectrum.points],
        [dataclasses.astuple(p) for p in ref.spectrum.points], equal_nan=True)
    assert port.closed_form_mean == ref.closed_form_mean


def same_topology(port, ref):
    assert port.plan == from_reference(ref.plan)
    assert port.generation == ref.generation
    assert port.dropped_workers == ref.dropped_workers
    assert port.assignment == (None if ref.assignment is None
                               else from_reference(ref.assignment))


# -------------------------------------------------------------- detector
@pytest.mark.parametrize("seed", range(4))
def test_straggler_detector_matches_reference(seed):
    """tests/test_fault_elastic_data.py's persistent straggler, with
    seeded fleets, missing (inf) times and a short history."""
    ref, port = (RDet(6, window=10, threshold=3.0, min_history=3),
                 TDet(6, window=10, threshold=3.0, min_history=3))
    rng = np.random.default_rng(seed)
    for step in range(10):
        t = rng.uniform(0.9, 1.1, 6)
        t[2] *= 50  # persistent straggler
        if seed % 2 and step > 4:
            t[4] = np.inf  # a worker that stopped reporting
        ref.observe(t)
        port.observe(t)
        np.testing.assert_array_equal(port.drop_mask(), ref.drop_mask())
    assert not port.drop_mask()[2]
    with pytest.raises(ValueError):
        port.observe(np.ones(5))


def test_straggler_detector_needs_history():
    det = TDet(4, min_history=5)
    det.observe(np.array([1.0, 1.0, 100.0, 1.0]))
    assert det.drop_mask().all()


# ---------------------------------------------------------- fault manager
def test_fault_manager_mask_vs_replan_matches_reference():
    ref = RFM(RPlan(8, 4), heartbeat_misses_fatal=2)
    port = TFM(TPlan(8, 4), heartbeat_misses_fatal=2, device=CPU)
    alive = np.ones(8, bool)
    dead1 = alive.copy()
    dead1[1] = False
    dead2 = dead1.copy()
    dead2[5] = False
    kinds = []
    for beats in ([alive], [dead1, dead1], [dead2, dead2]):
        for b in beats:
            ref.heartbeat(b)
            port.heartbeat(b)
        r, p = ref.decide(), port.decide()
        assert (p.kind, p.lost_batches, p.needs_restart) == (
            r.kind, r.lost_batches, r.needs_restart)
        np.testing.assert_array_equal(p.alive, r.alive)
        np.testing.assert_array_equal(port.dead_mask(), ref.dead_mask())
        kinds.append(p.kind)
    assert kinds == ["ok", "mask", "replan"]
    assert port.decide().lost_batches == (1,)


def test_fault_manager_decide_with_assignment_and_straggler_mask():
    """A rate-aware placement's worker->batch map, straggler drops and an
    immediate mark_dead."""
    rates = tuple(np.linspace(0.4, 1.6, 12))
    ref_asg = RHetero(n_trials=2_000).assignment_for(
        RSpec(n_workers=12, dist=RExp(1.0), rates=rates), 4)
    ref = RFM(RPlan(12, 4), heartbeat_misses_fatal=3)
    port = TFM(TPlan(12, 4), heartbeat_misses_fatal=3, device=CPU)
    keep = np.ones(12, bool)
    keep[[0, 7]] = False
    for w in (3, 4, 9):
        ref.mark_dead(w)
        port.mark_dead(w)
        r = ref.decide(keep, ref_asg)
        p = port.decide(keep, from_reference(ref_asg))
        assert (p.kind, p.lost_batches) == (r.kind, r.lost_batches)
        np.testing.assert_array_equal(p.alive, r.alive)
    with pytest.raises(ValueError, match="stale placement"):
        port.decide(assignment=from_reference(
            RHetero(n_trials=2_000).assignment_for(
                RSpec(n_workers=8, dist=RExp(1.0), rates=rates[:8]), 4)))
    with pytest.raises(ValueError):
        port.mark_dead(12)


def test_plan_recovery_analytic_matches_reference():
    """tests/test_planner.py: six survivors, B dividing 16, <= 4."""
    ref = RFM(RPlan(8, 4), heartbeat_misses_fatal=1)
    port = TFM(TPlan(8, 4), heartbeat_misses_fatal=1, device=CPU)
    responded = np.ones(8, bool)
    responded[[1, 5]] = False
    ref.heartbeat(responded)
    port.heartbeat(responded)
    r = ref.plan_recovery(RSExp(delta=1.0, mu=2.0), batch_divisor=16)
    p = port.plan_recovery(TSExp(delta=1.0, mu=2.0), batch_divisor=16)
    same_plan(p, r)
    assert (p.n_workers, p.n_batches, p.planner) == (6, 2, "analytic")


@pytest.mark.parametrize("metric", ["mean", "p99"])
def test_plan_recovery_keeps_survivor_rates(metric):
    ref = RFM(RPlan(8, 4), heartbeat_misses_fatal=1)
    port = TFM(TPlan(8, 4), heartbeat_misses_fatal=1, device=CPU)
    responded = np.ones(8, bool)
    responded[2] = False
    ref.heartbeat(responded)
    port.heartbeat(responded)
    rates = np.linspace(0.5, 1.9, 8)
    r = ref.plan_recovery(RExp(mu=1.0), rates=rates, metric=metric)
    p = port.plan_recovery(TExp(mu=1.0), rates=rates, metric=metric)
    same_plan(p, r)
    assert p.n_workers == 7 and p.planner == "heterogeneous"
    assert p.spec.rates == tuple(rates[np.arange(8) != 2])
    assert p.backend == "cpu"
    with pytest.raises(ValueError, match="rates shape"):
        port.plan_recovery(TExp(mu=1.0), rates=rates[:7])


def test_plan_recovery_on_the_bench_fleet_p99():
    """The rate-aware p99 recovery of bench_planner.py's skewed N 64
    fleet after its crippled host and one whole replica group died."""
    dist_r, dist_t = RSExp(0.25, 1.0), TSExp(0.25, 1.0)
    ref = RFM(RPlan(BENCH_N, 16), heartbeat_misses_fatal=1)
    port = TFM(TPlan(BENCH_N, 16), heartbeat_misses_fatal=1, device=CPU)
    for w in (0, 5, 21, 37, 53):
        ref.mark_dead(w)
        port.mark_dead(w)
    r, p = ref.decide(), port.decide()
    assert (p.kind, p.lost_batches) == (r.kind, r.lost_batches) == (
        "replan", (5,))
    rr = ref.plan_recovery(dist_r, rates=BENCH_RATES, metric="p99")
    pp = port.plan_recovery(dist_t, rates=BENCH_RATES, metric="p99")
    same_plan(pp, rr)
    assert pp.n_workers == BENCH_N - 5


# --------------------------------------------------------------- executor
def test_rescale_executor_matches_reference():
    """tests/test_fault_elastic_data.py's replan / bookkeeping shrink /
    homogeneous shrink sequence."""
    ref = RExec(RTopo(RPlan(16, 8), generation=0))
    port = TExec(TTopo(TPlan(16, 8), generation=0), device=CPU)
    same_topology(port.apply_replan(4), ref.apply_replan(4))
    same_topology(port.shrink(4), ref.shrink(4))
    same_topology(port.shrink(2, dist=TExp(mu=1.0)),
                  ref.shrink(2, dist=RExp(mu=1.0)))
    assert port.topology.plan.n_data == 10
    assert port.topology.plan.n_batches == 1
    assert port.topology.n_workers == 10
    with pytest.raises(RuntimeError, match="no workers"):
        port.shrink(10)


@pytest.mark.parametrize("metric", ["mean", "p99"])
def test_shrink_drops_the_slowest_like_the_reference(metric):
    rates = list(np.linspace(1.3, 0.7, 16))
    rates[3], rates[11] = 0.05, 0.08  # two crippled hosts
    ref = RExec(RTopo(RPlan(16, 8), generation=0))
    port = TExec(TTopo(TPlan(16, 8), generation=0), device=CPU)
    r = ref.shrink(2, dist=RExp(mu=1.0), rates=rates, metric=metric)
    p = port.shrink(2, dist=TExp(mu=1.0), rates=rates, metric=metric)
    same_topology(p, r)
    assert p.dropped_workers == (3, 11) and p.plan.n_data == 14
    with pytest.raises(ValueError):
        port.shrink(1, rates=rates)  # rates without a service model


@pytest.mark.parametrize("n_lost,dist,b0,divisor", [
    (6, "exp", 8, None),  # Thm 2: Exp -> full diversity
    (4, None, 8, None),  # no model: largest feasible B
    (2, "sexp", 2, None),  # never increases parallelism
    (3, None, 8, 4),  # the caller's data-sharding constraint
])
def test_shrink_homogeneous_matches_reference(n_lost, dist, b0, divisor):
    dists = {"exp": (RExp(mu=1.0), TExp(mu=1.0)),
             "sexp": (RSExp(delta=2.0, mu=1.0), TSExp(delta=2.0, mu=1.0)),
             None: (None, None)}[dist]
    ref = RExec(RTopo(RPlan(16, b0), generation=0))
    port = TExec(TTopo(TPlan(16, b0), generation=0), device=CPU)
    r = ref.shrink(n_lost, dist=dists[0], batch_divisor=divisor)
    p = port.shrink(n_lost, dist=dists[1], batch_divisor=divisor)
    same_topology(p, r)
    assert p.plan.n_batches <= b0


def test_apply_plan_adopts_the_planner_decision():
    rates = tuple(np.linspace(0.5, 1.5, 12))
    r_plan = RHetero(n_trials=4_000, seed=2).plan(
        RSpec(n_workers=12, dist=RExp(mu=1.0), rates=rates))
    p_plan = THetero(n_trials=4_000, seed=2, device=CPU).plan(
        TSpec(n_workers=12, dist=TExp(mu=1.0), rates=rates))
    same_plan(p_plan, r_plan)
    ref = RExec(RTopo(RPlan(12, 6), generation=3))
    port = TExec(TTopo(TPlan(12, 6), generation=3), device=CPU)
    same_topology(port.apply_plan(p_plan), ref.apply_plan(r_plan))
    assert port.topology.generation == 4
    assert port.topology.assignment == p_plan.assignment


# ------------------------------------------------------------ device rule
def test_fault_and_elastic_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TFM(TPlan(8, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        TExec(TTopo(TPlan(8, 4), generation=0))
    assert TFM(TPlan(8, 4), device=CPU).device == CPU
    assert TExec(TTopo(TPlan(8, 4), 0), device=CPU).device == CPU


# ----------------------------------------------------- the seam's cell split
def test_seam_split_over_two_devices_is_bit_equal(monkeypatch):
    """The bench fleet's load-aware policy sweep (every feasible B a cell)
    through the seam on one device and split over ["cpu", "cpu"]."""
    seam = TS._ss.sojourn_policy_cells
    seen = []

    def both(*args):
        one = seam(*args)
        two = seam(*args, devices=["cpu", "cpu"])
        three = seam(*args, devices=["cpu"] * 3)
        assert all(torch.equal(a, b) for a, b in zip(one, two))
        assert all(torch.equal(a, b) for a, b in zip(one, three))
        seen.append(args[1].shape)
        return one

    monkeypatch.setattr(TS._ss, "sojourn_policy_cells", both)
    pols = (TPol("none"), TPol("clone", quantile=0.9),
            TPol("relaunch", quantile=0.9), TPol("hedged", hedge_fraction=0.1))
    spec = TSpec(n_workers=BENCH_N, dist=TSExp(0.25, 1.0),
                 rates=tuple(BENCH_RATES))
    TS.sweep_sojourn_policies(
        spec.dist, BENCH_N, arrival_rate=0.5, policies=pols, n_jobs=300,
        seed=0, feasible_b=spec.feasible_batches(), rates=spec.rates,
        device=CPU)
    assert seen and seen[0][0] == len(spec.feasible_batches())
