"""The port's sweeps, sample for sample, against the reference's Pallas lane.

At N=16 and J=400 with a shifted exponential and an Empirical pool swept
together, each of the six sweeps of ``repro_torch.core.simulator`` run on
the CPU (the kernels' plain versions) is bit-equal to the reference run
with ``backend="pallas"`` (``sweep_simulate``'s pallas lane resolves onto
its jit lane).  The inputs are built once in the reference and converted.
"""

import numpy as np
import pytest

from repro.core import simulator as RS
from repro.core.coding import CodingCandidate as RCode
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import PolicyCandidate as RPol
from repro_torch.convert import from_reference
from repro_torch.core import simulator as TS

N = 16
J = 400
SPLITS = [2, 4, 8]
R_DISTS = [RSExp(0.05, 2.0),
           REmp(np.random.default_rng(5).gamma(2.0, 0.5, 300))]
R_POLS = (RPol("none"), RPol("clone", quantile=0.85),
          RPol("relaunch", quantile=0.9), RPol("hedged", hedge_fraction=0.3))
R_CODES = (RCode("mds", 4, encode_overhead=0.01, decode_overhead=0.02),
           RCode("cyclic", 2, encode_overhead=0.0, decode_overhead=0.0),
           RCode("mds", 12, encode_overhead=0.003, decode_overhead=0.0))
SOJ = dict(arrival_rate=4.0, n_jobs=J, seed=3, feasible_b=SPLITS)

T_DISTS = from_reference(R_DISTS)
T_POLS = from_reference(R_POLS)
T_CODES = from_reference(R_CODES)


def _same(ref, port):
    assert port.backend == "cpu"
    np.testing.assert_array_equal(port.samples, ref.samples)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_simulate_bit_equal(seed):
    ref = RS.sweep_simulate(R_DISTS, N, n_trials=J, seed=seed,
                            feasible_b=[1, 2, 4, 8, 16], backend="pallas")
    port = TS.sweep_simulate(T_DISTS, N, n_trials=J, seed=seed,
                             feasible_b=[1, 2, 4, 8, 16], device="cpu")
    _same(ref, port)


def test_sweep_simulate_worker_batches_and_rates_bit_equal():
    rng = np.random.default_rng(1)
    wbs = [rng.permutation(np.arange(N) % b) for b in SPLITS]
    rates = np.linspace(0.5, 1.5, N)
    ref = RS.sweep_simulate(R_DISTS, N, n_trials=J, seed=2, feasible_b=SPLITS,
                            rates=rates, worker_batches=wbs, backend="pallas")
    port = TS.sweep_simulate(T_DISTS, N, n_trials=J, seed=2, feasible_b=SPLITS,
                             rates=rates, worker_batches=wbs, device="cpu")
    _same(ref, port)


def test_sweep_sojourn_bit_equal():
    ref = RS.sweep_sojourn(R_DISTS, N, backend="pallas", **SOJ)
    port = TS.sweep_sojourn(T_DISTS, N, device="cpu", **SOJ)
    _same(ref, port)


def test_sweep_sojourn_speculative_bit_equal():
    q = (None, 0.8, 0.95)
    ref = RS.sweep_sojourn_speculative(R_DISTS, N, quantiles=q,
                                       backend="pallas", **SOJ)
    port = TS.sweep_sojourn_speculative(T_DISTS, N, quantiles=q, device="cpu",
                                        **SOJ)
    _same(ref, port)
    np.testing.assert_array_equal(port.clone_fraction, ref.clone_fraction)


def test_sweep_sojourn_policies_bit_equal():
    ref = RS.sweep_sojourn_policies(R_DISTS, N, policies=R_POLS,
                                    backend="pallas", **SOJ)
    port = TS.sweep_sojourn_policies(T_DISTS, N, policies=T_POLS,
                                     device="cpu", **SOJ)
    _same(ref, port)
    np.testing.assert_array_equal(port.extra_fraction, ref.extra_fraction)
    assert port.policies == T_POLS


def test_sweep_sojourn_policies_weighted_empirical_and_rates_bit_equal():
    """The weighted-ECDF coupling (Kaplan-Meier weights) and the skewed-
    rates materialization path, with a trace of explicit arrivals."""
    rng = np.random.default_rng(9)
    times = rng.gamma(2.0, 0.5, 200)
    censored = rng.random(200) < 0.3
    r_dists = [REmp.from_censored(times, censored), R_DISTS[0]]
    arrivals = np.cumsum(rng.exponential(0.25, 150))
    kw = dict(n_jobs=J, seed=4, feasible_b=SPLITS, arrival_rate=4.0,
              arrivals=arrivals)
    for rates in (None, np.linspace(0.6, 1.4, N)):
        ref = RS.sweep_sojourn_policies(r_dists, N, policies=R_POLS,
                                        rates=rates, backend="pallas", **kw)
        port = TS.sweep_sojourn_policies(from_reference(r_dists), N,
                                         policies=T_POLS, rates=rates,
                                         device="cpu", **kw)
        _same(ref, port)


def test_sweep_coded_bit_equal():
    ref = RS.sweep_coded(R_DISTS, N, R_CODES, n_trials=J, seed=5,
                         backend="pallas")
    port = TS.sweep_coded(T_DISTS, N, T_CODES, n_trials=J, seed=5,
                          device="cpu")
    _same(ref, port)


def test_sweep_sojourn_coded_bit_equal():
    kw = dict(arrival_rate=0.6, n_jobs=J, seed=2)
    ref = RS.sweep_sojourn_coded(R_DISTS, N, R_CODES, backend="pallas", **kw)
    port = TS.sweep_sojourn_coded(T_DISTS, N, T_CODES, device="cpu", **kw)
    _same(ref, port)


def test_sweeps_need_a_device_or_an_explicit_cpu():
    """device=None means cuda: on a host without a card it raises instead
    of quietly running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.sweep_sojourn(T_DISTS, N, **SOJ)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.sweep_coded(T_DISTS, N, T_CODES, n_trials=10)


def test_validation_matches_reference_contracts():
    with pytest.raises(ValueError, match="infeasible"):
        TS.sweep_simulate(T_DISTS, N, n_trials=10, feasible_b=[3],
                          device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        TS.sweep_sojourn(T_DISTS, N, warmup=J, device="cpu", **SOJ)
    with pytest.raises(TypeError, match="PolicyCandidate"):
        TS.sweep_sojourn_policies(T_DISTS, N, policies=("clone",),
                                  device="cpu", **SOJ)
    with pytest.raises(ValueError, match="tolerates every worker"):
        TS.sweep_coded(T_DISTS, N, from_reference((RCode("mds", N),)),
                       n_trials=10, device="cpu")


def test_stage_seconds_cover_every_stage_and_leave_results_alone():
    """The stage timer records each stage of a policy sweep and the samples
    stay bit-equal to an untimed run of the reference."""
    TS.reset_stage_seconds()
    port = TS.sweep_sojourn_policies(T_DISTS, N, policies=T_POLS,
                                     device="cpu", **SOJ)
    stages = dict(TS.STAGE_SECONDS)
    assert set(stages) == {"draws", "h2d", "group_min", "thresholds",
                           "cells", "scan"}
    assert all(v >= 0.0 for v in stages.values())
    ref = RS.sweep_sojourn_policies(R_DISTS, N, policies=R_POLS,
                                    backend="pallas", **SOJ)
    _same(ref, port)
    TS.reset_stage_seconds()
    assert TS.STAGE_SECONDS == {}
