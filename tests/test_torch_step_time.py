"""Step-time telemetry, batch completion of one placement and gradient
coding: the port against the reference.

(1) ``StepTimeSimulator`` is bit-equal to the reference's, step for step,
    under Exp, SExp and ``Empirical`` (uniform and Kaplan-Meier weights)
    distributions, per-worker ``rates``, ``slow_workers`` and faults, with
    and without per-worker loads; ``completion_from_step_times`` and
    ``censored_observations`` equal the reference's on the same times.
(2) ``simulate_maxmin`` and ``simulate_coverage`` (float64 torch on the
    CPU) are bit-equal to the reference's numpy samples, the latter over
    balanced, unbalanced, overlapping, random and rate-aware placements,
    more than 64 data units and chunks of trials, and to the port's own
    host oracle ``simulate_coverage_reference``.
(3) ``simulate_gradient_coding`` (one ``coded_cells`` cell, float32) is
    bit-equal to the cyclic cell of the reference's ``sweep_coded`` on its
    ``pallas`` lane, and equals the float32 rounding of the reference's
    float64 samples exactly (rounding is monotone, so it commutes with
    the order statistic); ``expected_coding_time`` is the reference's;
    ``compare_schemes`` agrees within 1e-12 relative (a float64 mean over
    trials summed in another order).

Inputs come from numpy seeds; the reference's Pallas kernel runs in
interpret mode on the CPU.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

from repro.core import gradient_coding as RG
from repro.core import simulator as RS
from repro.core.coding import CodingCandidate as RCode
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import Exponential as RExp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import balanced_nonoverlapping as r_balanced
from repro.core.policies import overlapping_cyclic as r_overlapping
from repro.core.policies import random_assignment as r_random
from repro.core.policies import rate_aware_assignment as r_rate_aware
from repro.core.policies import unbalanced_nonoverlapping as r_unbalanced
from repro_torch.convert import from_reference
from repro_torch.core import gradient_coding as TG
from repro_torch.core import simulator as TS

SEXP = RSExp(0.2, 1.5)
EMP = REmp(tuple(np.random.default_rng(4).gamma(2.0, 1.0, 1_000)))
# Kaplan-Meier weights: a censored window, as the tuner's telemetry gives
_w = np.random.default_rng(6).exponential(1.0, 600)
KM = REmp.from_censored(_w, _w > np.quantile(_w, 0.8))
DISTS = {"exp": RExp(2.0), "sexp": SEXP, "empirical": EMP, "km": KM}


def _assignments(seed):
    return {
        "balanced": r_balanced(8, 4),
        "unbalanced": r_unbalanced(8, [1, 1, 3, 3]),
        "overlapping": r_overlapping(16, 4),
        "random": r_random(12, 4, seed=seed),
        "rate_aware": r_rate_aware(8, 2, 0.5 + np.arange(8) / 4.0),
        "many_units": r_balanced(96, 8),
    }


# -- (1) telemetry -------------------------------------------------------------


@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("variant", ["plain", "rates", "slow_faults_loads"])
def test_step_time_simulator_matches_reference(dist, variant):
    n = 6
    kw = {}
    if variant == "rates":
        kw["rates"] = np.array([1.0, 0.1, 1.0, 2.5, 0.7, 1.3])
    if variant == "slow_faults_loads":
        kw["slow_workers"] = {1: 100.0, 4: 3.5}
        kw["faults"] = [RS.FaultEvent(2, 1, 3), RS.FaultEvent(5, 0, 2)]
    ref = RS.StepTimeSimulator(DISTS[dist], n, seed=11, **kw)
    port = TS.StepTimeSimulator(
        from_reference(DISTS[dist]), n, seed=11,
        **{k: from_reference(v) if k == "faults" else v
           for k, v in kw.items()})
    loads = (np.array([1.0, 2.0, 0.5, 4.0, 1.0, 3.0])
             if variant == "slow_faults_loads" else None)
    for _ in range(8):
        np.testing.assert_array_equal(ref.alive_mask(), port.alive_mask())
        a, b = ref.next_step(loads), port.next_step(loads)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert port.step == ref.step == 8


def test_step_time_simulator_faults_and_slowdowns():
    """tests/test_policies_simulator.py's fault and slow-worker case."""
    sim = TS.StepTimeSimulator(
        from_reference(RExp(5.0)), 4, seed=0, slow_workers={1: 100.0},
        faults=[TS.FaultEvent(worker=2, start_step=1, end_step=3)])
    assert np.isfinite(sim.next_step()).all()
    assert np.isinf(sim.next_step()[2])
    slows = [sim.next_step() for _ in range(50)]
    assert (np.median([s[1] for s in slows])
            > 10 * np.median([s[0] for s in slows]))


def test_step_time_simulator_hetero_rates_and_empirical_iid():
    """tests/test_sim_engine.py's rate and i.i.d. empirical cases."""
    rates = np.ones(4)
    rates[3] = 0.1
    sim = TS.StepTimeSimulator(from_reference(RExp(2.0)), 4, seed=1,
                               rates=rates)
    draws = np.stack([sim.next_step() for _ in range(400)])
    assert np.median(draws[:, 3]) > 4 * np.median(draws[:, 0])
    emp = from_reference(EMP)
    sim = TS.StepTimeSimulator(emp, 8, seed=5)
    steps = np.stack([sim.next_step() for _ in range(20)])
    assert len({tuple(np.sort(row)) for row in steps}) > 1
    assert np.isin(steps, np.asarray(emp.atoms)).all()
    slow = np.ones(4)
    slow[2] = 0.5
    t0 = np.stack([TS.StepTimeSimulator(emp, 4, seed=3).next_step()
                   for _ in range(3)])
    t1 = np.stack([TS.StepTimeSimulator(emp, 4, seed=3, rates=slow)
                   .next_step() for _ in range(3)])
    np.testing.assert_array_equal(2.0 * t0[:, 2], t1[:, 2])
    with pytest.raises(ValueError):
        TS.StepTimeSimulator(emp, 4, rates=np.ones(3))
    with pytest.raises(ValueError):
        TS.StepTimeSimulator(emp, 4, slow_workers={7: 2.0})


@pytest.mark.parametrize("name", sorted(_assignments(3)))
def test_completion_and_censoring_match_reference(name):
    a = _assignments(3)[name]
    rng = np.random.default_rng(9)
    for _ in range(5):
        times = rng.exponential(1.0, a.n_workers)
        times[rng.random(a.n_workers) < 0.2] = np.inf
        ref_t, ref_used = RS.completion_from_step_times(times, a)
        t, used = TS.completion_from_step_times(times, from_reference(a))
        assert t == ref_t
        np.testing.assert_array_equal(used, ref_used)
        ref_obs = RS.censored_observations(times, a, ref_used)
        obs = TS.censored_observations(times, from_reference(a), used)
        for x, y in zip(ref_obs, obs):
            np.testing.assert_array_equal(x, y)


def test_completion_uses_fastest_replica_and_dead_batch_is_inf():
    """tests/test_policies_simulator.py's two hand cases."""
    a = from_reference(r_balanced(4, 2))
    t, used = TS.completion_from_step_times(np.array([3.0, 1.0, 9.0, 2.0]), a)
    assert t == 2.0 and used.tolist() == [False, True, False, True]
    t, used = TS.completion_from_step_times(
        np.array([np.inf, np.inf, 1.0, 2.0]), a)
    assert np.isinf(t) and used.tolist() == [False, False, True, False]


# -- (2) batch completion of one placement ------------------------------------


@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("skewed", [False, True])
def test_simulate_maxmin_matches_reference(dist, skewed):
    rates = np.random.default_rng(2).uniform(0.2, 3.0, 12) if skewed else None
    for b in (1, 3, 4, 12):
        ref = RS.simulate_maxmin(DISTS[dist], 12, b, n_trials=500, seed=7,
                                 rates=rates)
        port = TS.simulate_maxmin(from_reference(DISTS[dist]), 12, b,
                                  n_trials=500, seed=7, rates=rates,
                                  device="cpu")
        np.testing.assert_array_equal(ref.samples, port.samples)
    with pytest.raises(ValueError):
        TS.simulate_maxmin(from_reference(DISTS[dist]), 12, 5, device="cpu")


@pytest.mark.parametrize("name", sorted(_assignments(3)))
@pytest.mark.parametrize("dist", ["exp", "sexp", "empirical"])
def test_simulate_coverage_matches_reference(name, dist):
    a = _assignments(3)[name]
    rates = np.random.default_rng(0).uniform(0.2, 3.0, a.n_workers)
    for r in (None, rates):
        ref = RS.simulate_coverage(DISTS[dist], a, n_trials=300, seed=7,
                                   rates=r)
        port = TS.simulate_coverage(from_reference(DISTS[dist]),
                                    from_reference(a), n_trials=300, seed=7,
                                    rates=r, device="cpu")
        np.testing.assert_array_equal(ref.samples, port.samples)
        oracle = TS.simulate_coverage_reference(
            from_reference(DISTS[dist]), from_reference(a), n_trials=300,
            seed=7, rates=r, device="cpu")
        np.testing.assert_array_equal(oracle.samples, port.samples)


def test_simulate_coverage_in_chunks_of_trials(monkeypatch):
    """The scan holds a bounded (trials, N, W) block: chunks of 7 trials
    give the samples one chunk gives."""
    a = from_reference(r_overlapping(16, 4))
    whole = TS.simulate_coverage(from_reference(SEXP), a, n_trials=100,
                                 seed=1, device="cpu")
    monkeypatch.setattr(TS, "_COVERAGE_CHUNK_WORDS", 7 * 16)
    chunked = TS.simulate_coverage(from_reference(SEXP), a, n_trials=100,
                                   seed=1, device="cpu")
    np.testing.assert_array_equal(whole.samples, chunked.samples)


def test_coverage_equals_maxmin_for_balanced():
    """tests/test_policies_simulator.py: the coverage rule on the balanced
    placement is max-min, and an exact-draw Empirical pool reproduces the
    parametric samples (tests/test_sim_engine.py's coupling pin)."""
    d = from_reference(RExp(1.0))
    a = from_reference(r_balanced(8, 4))
    cov = TS.simulate_coverage(d, a, n_trials=4000, seed=5, device="cpu")
    mm = TS.simulate_maxmin(d, 8, 4, n_trials=4000, seed=5, device="cpu")
    np.testing.assert_array_equal(cov.samples, mm.samples)
    unit = np.random.default_rng(9).standard_exponential((300, 16))
    sexp = from_reference(SEXP)
    pool = TS.Empirical(tuple((sexp.delta + unit / sexp.mu).ravel()))
    for b in (2, 4, 16):
        np.testing.assert_array_equal(
            TS.simulate_maxmin(pool, 16, b, n_trials=300, seed=9,
                               device="cpu").samples,
            TS.simulate_maxmin(sexp, 16, b, n_trials=300, seed=9,
                               device="cpu").samples)


def test_per_placement_entries_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.simulate_maxmin(from_reference(SEXP), 4, 2, n_trials=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.simulate_gradient_coding(from_reference(SEXP), 4, 1, n_trials=10)


# -- (3) gradient coding -------------------------------------------------------


@pytest.mark.parametrize("dist", ["exp", "sexp", "empirical"])
def test_simulate_gradient_coding_matches_reference(dist):
    n, trials, seed = 12, 400, 3
    cands = tuple(RCode("cyclic", s, encode_overhead=0.0, decode_overhead=0.0)
                  for s in (0, 3, 7, 11))
    RS._GROUP_MIN_CACHE.clear()
    ref_lane = RS.sweep_coded(DISTS[dist], n, cands, n_trials=trials,
                              seed=seed, backend="pallas")
    for ci, c in enumerate(cands):
        port = TG.simulate_gradient_coding(from_reference(DISTS[dist]), n,
                                           c.s, n_trials=trials, seed=seed,
                                           device="cpu")
        np.testing.assert_array_equal(port.samples, ref_lane.samples[0, ci])
        ref64 = RG.simulate_gradient_coding(DISTS[dist], n, c.s,
                                            n_trials=trials, seed=seed)
        np.testing.assert_array_equal(
            port.samples, ref64.samples.astype(np.float32).astype(np.float64))
    with pytest.raises(ValueError):
        TG.simulate_gradient_coding(from_reference(SEXP), n, n, device="cpu")


@pytest.mark.parametrize("s", [0, 1, 5, 15])
def test_expected_coding_time_matches_reference(s):
    for d in (RExp(2.0), SEXP):
        assert (TG.expected_coding_time(from_reference(d), 16, s)
                == RG.expected_coding_time(d, 16, s))
    with pytest.raises(TypeError):
        TG.expected_coding_time(from_reference(EMP), 16, s)


@pytest.mark.parametrize("dist", ["exp", "sexp", "empirical"])
def test_compare_schemes_matches_reference(dist):
    ref = RG.compare_schemes(DISTS[dist], 12, n_trials=2_000, seed=4)
    port = TG.compare_schemes(from_reference(DISTS[dist]), 12,
                              n_trials=2_000, seed=4, device="cpu")
    assert port.keys() == ref.keys()
    for part in ("replication", "coding"):
        assert port[part].keys() == ref[part].keys()
        for k, v in ref[part].items():
            assert port[part][k] == pytest.approx(v, rel=1e-12, abs=0.0)
    assert port["common"].keys() == ref["common"].keys()
