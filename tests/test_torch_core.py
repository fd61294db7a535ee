"""The port's host-side core against the reference's, value for value.

Bit-equal (``==`` / ``assert_array_equal``): divisors, assignments, the
closed forms, the Empirical ECDF (ppf, cdf, quantile, moments), the
Kaplan-Meier construction, the MDS / polynomial / cyclic codes (generator,
coefficients, decode weights), the fits, the KS gate and the policy work
factors — the port keeps its own copy of the same numpy code.  Within
1e-12 relative: decoded data blocks, which go through a linear solve.
"""

import math

import numpy as np
import pytest

from repro.core import coding as RC
from repro.core import estimator as RE
from repro.core import gradient_coding as RG
from repro.core import order_stats as RO
from repro.core import policies as RPo
from repro.core import replication as RR
from repro.core import spectrum as RSp
from repro_torch.convert import empirical_from_fields, from_reference
from repro_torch.core import coding as TC
from repro_torch.core import estimator as TE
from repro_torch.core import gradient_coding as TG
from repro_torch.core import order_stats as TO
from repro_torch.core import policies as TPo
from repro_torch.core import replication as TR
from repro_torch.core import spectrum as TSp

DISTS = [RO.Exponential(1.5), RO.ShiftedExponential(0.2, 3.0)]


@pytest.mark.parametrize("n", [1, 12, 36, 97, 10_000])
def test_divisors_equal(n):
    assert TPo.divisors(n) == RPo.divisors(n)


@pytest.mark.parametrize("dist", DISTS, ids=["exp", "sexp"])
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
def test_closed_forms_bit_equal(dist, b):
    t = from_reference(dist)
    assert TO.completion_mean(t, 16, b) == RO.completion_mean(dist, 16, b)
    assert TO.completion_var(t, 16, b) == RO.completion_var(dist, 16, b)
    for q in (0.5, 0.99, 0.999):
        assert (TO.completion_quantile(t, 16, b, q)
                == RO.completion_quantile(dist, 16, b, q))
    for k in (1, 8, 16):
        assert (TC.expected_kofn_time(t, 16, k, load=16 / b)
                == RC.expected_kofn_time(dist, 16, k, load=16 / b))


def test_heterogeneous_closed_forms_bit_equal():
    rates = [0.5, 1.0, 1.5, 2.0, 0.7, 1.1]
    for dist in DISTS:
        t = from_reference(dist)
        wb = [0, 1, 0, 1, 2, 2]
        assert (TO.expected_completion_rates(t, 6, wb, rates)
                == RO.expected_completion_rates(dist, 6, wb, rates))
        assert (TO.expected_max_min_groups(t, 6, [1, 2, 3])
                == RO.expected_max_min_groups(dist, 6, [1, 2, 3]))
    assert TO.harmonic(50) == RO.harmonic(50)
    assert TO.generalized_harmonic(50, 3) == RO.generalized_harmonic(50, 3)


@pytest.mark.parametrize("b", [1, 3, 4, 12])
def test_assignments_equal(b):
    rates = np.random.default_rng(b).uniform(0.5, 2.0, 12)
    pairs = [
        (TPo.balanced_nonoverlapping(12, b), RPo.balanced_nonoverlapping(12, b)),
        (TPo.replica_major_nonoverlapping(12, b),
         RPo.replica_major_nonoverlapping(12, b)),
        (TPo.overlapping_cyclic(12, b), RPo.overlapping_cyclic(12, b)),
        (TPo.rate_aware_assignment(12, b, rates),
         RPo.rate_aware_assignment(12, b, rates)),
        (TPo.random_assignment(12, b, seed=3), RPo.random_assignment(12, b, 3)),
    ]
    for t, r in pairs:
        assert t.worker_batch == r.worker_batch
        assert t.batches == r.batches
        assert t.replication == r.replication
        np.testing.assert_array_equal(t.coverage_matrix(), r.coverage_matrix())
    u = TPo.unbalanced_nonoverlapping(12, [5, 4, 3])
    assert u.worker_batch == RPo.unbalanced_nonoverlapping(12, [5, 4, 3]).worker_batch


@pytest.mark.parametrize("weighted", [False, True])
def test_empirical_ecdf_bit_equal(weighted):
    rng = np.random.default_rng(11)
    atoms = rng.gamma(2.0, 0.5, 257)
    weights = rng.uniform(0.1, 1.0, 257) if weighted else None
    ref = RO.Empirical(atoms, weights)
    port = TO.Empirical(atoms, weights)
    assert port.atoms == ref.atoms and port.weights == ref.weights
    conv = from_reference(ref)
    assert conv == port
    u = np.linspace(0.0, 1.0, 1001)
    grid = np.linspace(-0.1, 4.0, 517)
    for t in (port, conv):
        np.testing.assert_array_equal(t.ppf(u), ref.ppf(u))
        np.testing.assert_array_equal(t.cdf(grid), ref.cdf(grid))
        assert t.mean() == ref.mean() and t.var() == ref.var()
        assert t.quantile(0.99) == ref.quantile(0.99)
    assert port.scaled(3.0).atoms == ref.scaled(3.0).atoms


def test_kaplan_meier_and_from_censored_bit_equal():
    rng = np.random.default_rng(4)
    times = np.round(rng.exponential(1.0, 400), 2)  # rounded: tied times
    censored = rng.random(400) < 0.35
    censored[np.argmax(times)] = True  # Efron tail collapse path
    ta, tm, tl = TO._kaplan_meier(times, censored)
    ra, rm, rl = RO._kaplan_meier(times, censored)
    np.testing.assert_array_equal(ta, ra)
    np.testing.assert_array_equal(tm, rm)
    assert tl == rl
    t = TO.Empirical.from_censored(times, censored)
    r = RO.Empirical.from_censored(times, censored)
    assert t.atoms == r.atoms and t.weights == r.weights
    assert from_reference(r) == t


def test_convert_keeps_normalized_weights_exactly():
    r = RO.Empirical((3.0, 1.0, 2.0), (0.1, 0.7, 0.2))
    t = empirical_from_fields(r.atoms, r.weights)
    assert t.weights == r.weights
    np.testing.assert_array_equal(t._cum_weights, r._cum_weights)
    with pytest.raises(ValueError, match="sorted"):
        empirical_from_fields((2.0, 1.0))


@pytest.mark.parametrize("n,k", [(16, 4), (16, 12), (8, 8), (5, 1)])
def test_mds_code_bit_equal(n, k):
    t, r = TC.MDSCode(n, k), RC.MDSCode(n, k)
    np.testing.assert_array_equal(t.generator(), r.generator())
    alive = np.zeros(n, bool)
    alive[np.random.default_rng(n + k).permutation(n)[:k]] = True
    np.testing.assert_array_equal(t.decode_weights(alive),
                                  r.decode_weights(alive))
    blocks = np.random.default_rng(0).standard_normal((k, 6))
    coded = r.encode(blocks)
    np.testing.assert_array_equal(t.encode(blocks), coded)
    np.testing.assert_allclose(t.decode(coded[alive], alive),
                               r.decode(coded[alive], alive), rtol=1e-12,
                               atol=0.0)


def test_polynomial_matmul_code_equal():
    t, r = TC.PolynomialMatmulCode(2, 2, 6), RC.PolynomialMatmulCode(2, 2, 6)
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((4, 3)), rng.standard_normal((6, 3))
    ea, eb = r.encode_a(a), r.encode_b(b)
    np.testing.assert_array_equal(t.encode_a(a), ea)
    np.testing.assert_array_equal(t.encode_b(b), eb)
    alive = np.array([1, 0, 1, 1, 0, 1], bool)
    prods = np.stack([r.worker_product(ea[i], eb[i]) for i in range(6)])[alive]
    np.testing.assert_allclose(t.decode(prods, alive), r.decode(prods, alive),
                               rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("s", [0, 1, 3])
def test_cyclic_gradient_code_bit_equal(s):
    t, r = TG.CyclicGradientCode(8, s), RG.CyclicGradientCode(8, s)
    np.testing.assert_array_equal(t.coefficients(), r.coefficients())
    np.testing.assert_array_equal(t.assignment(), r.assignment())
    alive = np.ones(8, bool)
    alive[:s] = False
    np.testing.assert_array_equal(t.decode_weights(alive),
                                  r.decode_weights(alive))


def test_coding_candidate_fields_equal():
    for scheme, s in (("cyclic", 2), ("mds", 5), ("poly", 3)):
        r = RC.CodingCandidate(scheme, s, encode_overhead=0.1)
        t = from_reference(r)
        assert (t.k(16), t.load(16), t.resolved, t.total_overhead,
                t.describe()) == (r.k(16), r.load(16), r.resolved,
                                  r.total_overhead, r.describe())
    np.testing.assert_array_equal(TC.chebyshev_nodes(9),
                                  RC.chebyshev_nodes(9))


def test_fits_and_ks_gate_bit_equal():
    rng = np.random.default_rng(8)
    x = 0.3 + rng.exponential(0.5, 300)
    c = rng.random(300) < 0.2
    for cens in (None, c):
        for fit in ("fit_exponential", "fit_shifted_exponential", "fit_best"):
            t, r = getattr(TE, fit)(x, cens), getattr(RE, fit)(x, cens)
            assert from_reference(r.dist) == t.dist
            assert (t.log_likelihood, t.aic) == (r.log_likelihood, r.aic)
        g_t = TE.goodness_of_fit(x, from_reference(DISTS[1]), cens)
        g_r = RE.goodness_of_fit(x, DISTS[1], cens)
        assert (g_t.statistic, g_t.threshold, g_t.rejected) == (
            g_r.statistic, g_r.threshold, g_r.rejected)
    assert TE.ks_critical(50, 0.05) == RE.ks_critical(50, 0.05)


def test_policy_work_factors_equal():
    emp = RO.Empirical(np.random.default_rng(1).gamma(2.0, 0.5, 100))
    for pol in (RPo.PolicyCandidate("none"),
                RPo.PolicyCandidate("clone", quantile=0.8),
                RPo.PolicyCandidate("relaunch", quantile=0.9),
                RPo.PolicyCandidate("hedged", hedge_fraction=0.4)):
        t = from_reference(pol)
        assert t.enabled == pol.enabled
        for d in DISTS + [emp, None]:
            assert t.work_factor(from_reference(d)) == pol.work_factor(d)


def test_spectrum_and_replication_plan_equal():
    for dist in DISTS:
        r = RSp.sweep(dist, 24)
        t = TSp.sweep(from_reference(dist), 24)
        assert [dataclass_tuple(p) for p in t.points] == [
            dataclass_tuple(p) for p in r.points]
        assert t.best("p999").n_batches == r.best("p999").n_batches
        assert [p.n_batches for p in t.pareto_front()] == [
            p.n_batches for p in r.pareto_front()]
    samples = np.random.default_rng(0).exponential(1.0, 500)
    assert dataclass_tuple(TSp.point_from_samples(4, 2, samples)) == \
        dataclass_tuple(RSp.point_from_samples(4, 2, samples))
    tp, rp = TR.ReplicationPlan(12, 4), RR.ReplicationPlan(12, 4)
    assert tp.expected_step_stats(from_reference(DISTS[1])) == \
        rp.expected_step_stats(DISTS[1])
    assert [TR.batch_index_for_data_coord(tp, i) for i in range(12)] == [
        RR.batch_index_for_data_coord(rp, i) for i in range(12)]


def dataclass_tuple(p):
    return (p.n_batches, p.replication, p.mean, p.var, p.p99,
            p.p999 if not math.isnan(p.p999) else None)
