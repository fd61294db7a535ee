"""Fig. 2 of the paper, pinned in the port against the reference.

``benchmarks/bench_fig2_spectrum.py``'s grid: N = 64 workers, mu = 1.0,
Delta in {0.01, 0.05, 0.25, 1.0}.  The port's ``AnalyticPlanner`` picks
the reference's B* at every Delta, and B* does not fall as Delta*mu
grows (the optimum moves toward parallelism).  At those B the port's
``sweep_simulate(device="cpu")`` is bit-equal to the reference's
``backend="pallas"`` lane at the bench's seed 3, at 4,000 trials (the
bench takes 20,000), and the simulated mean at B* lies within
5 stderr + 1e-3 of the closed-form ``completion_mean``, the bench's own
check.
"""

import numpy as np
import pytest

from repro.core import planner as RP
from repro.core import simulator as RS
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.order_stats import completion_mean as r_completion_mean
from repro_torch.convert import from_reference
from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.core.order_stats import completion_mean

N, MU, SEED, TRIALS = 64, 1.0, 3, 4_000
DELTAS = (0.01, 0.05, 0.25, 1.0)


def _b_star(planner_mod, dist):
    return planner_mod.AnalyticPlanner().plan(
        planner_mod.ClusterSpec(n_workers=N, dist=dist)).n_batches


def test_fig2_b_star_equals_reference_and_grows_with_delta_mu():
    stars = []
    for delta in DELTAS:
        r_dist = RSExp(delta=delta, mu=MU)
        b = _b_star(TP, from_reference(r_dist))
        assert b == _b_star(RP, r_dist)
        stars.append(b)
    assert stars == sorted(stars)
    assert stars[-1] > stars[0]  # the optimum does move


@pytest.mark.parametrize("delta", DELTAS)
def test_fig2_sweep_at_b_star_bit_equal_and_near_closed_form(delta):
    r_dist = RSExp(delta=delta, mu=MU)
    t_dist = from_reference(r_dist)
    b = _b_star(TP, t_dist)
    ref = RS.sweep_simulate(r_dist, N, n_trials=TRIALS, seed=SEED,
                            feasible_b=[b], backend="pallas")
    port = TS.sweep_simulate(t_dist, N, n_trials=TRIALS, seed=SEED,
                             feasible_b=[b], device="cpu")
    np.testing.assert_array_equal(port.samples, ref.samples)
    sim = port.result(b)
    closed = completion_mean(t_dist, N, b)
    assert closed == r_completion_mean(r_dist, N, b)
    assert abs(sim.mean - closed) < 5 * sim.stderr + 1e-3
