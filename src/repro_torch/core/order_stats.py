"""Closed-form order statistics for the paper's completion-time analysis.

The paper (Behrouzi-Far & Soljanin, 2019) normalizes the dataset size to
``|D| = N`` units (one unit per worker at full parallelism).  With ``B``
disjoint batches (``B | N``) each batch has size ``s = N/B`` and is assigned
to ``r = N/B`` workers.  Under the size-dependent service model of Gardner
et al. (MASCOTS'16):

* ``Exp``  : a batch of size ``s`` is served at rate ``mu / s``
* ``SExp`` : a batch of size ``s`` has shift ``s * Delta`` and rate ``mu / s``

Job completion (System1) is ``T(B) = max_i min_j T_ij`` — every batch needs
at least one finished replica.  The min of ``r`` i.i.d. ``Exp(mu * B / N)``
is ``Exp(r * mu * B / N) = Exp(mu)``, hence

    E[T] = N*Delta/B + H_B / mu          (Thm 3; Delta=0 gives Thm 2)
    Var[T] = (sum_{k=1..B} k^-2) / mu^2  (Thms 2 & 4 — shift is deterministic)

Everything in this module is plain python/numpy math (no torch) so it can be
used by the control plane (planner / spectrum optimizer) without touching
device state.  It is the port's own copy of ``repro.core.order_stats``.

Beyond the paper's two parametric families, :class:`Empirical` carries a
(weighted) ECDF fitted straight from telemetry — censoring-aware via
Kaplan-Meier (:meth:`Empirical.from_censored`) — so the whole
``ClusterSpec -> Plan`` pipeline can plan for ANY measured workload.

Heterogeneous workers (per-worker rate multipliers ``rates[j]``, the
simulator's slow-node model): :func:`expected_completion_rates` gives E[T]
for any non-overlapping equal-size-batch assignment via the aggregate rate
of each batch's replica set.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
import itertools
import math
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "harmonic",
    "generalized_harmonic",
    "ServiceDistribution",
    "Exponential",
    "ShiftedExponential",
    "Empirical",
    "batch_service",
    "completion_mean",
    "completion_var",
    "completion_quantile",
    "expected_max_exponential",
    "expected_max_min_groups",
    "expected_completion_rates",
]


def harmonic(n: int) -> float:
    """H_n = sum_{k=1..n} 1/k (exact summation; n is small in practice)."""
    if n < 0:
        raise ValueError(f"harmonic undefined for n={n}")
    return sum(1.0 / k for k in range(1, n + 1))


def generalized_harmonic(n: int, p: int = 2) -> float:
    """H_n^(p) = sum_{k=1..n} k^-p."""
    if n < 0:
        raise ValueError(f"generalized_harmonic undefined for n={n}")
    return sum(k ** (-float(p)) for k in range(1, n + 1))


@dataclasses.dataclass(frozen=True)
class ServiceDistribution(abc.ABC):
    """Base class: service time of ONE unit of data on one worker."""

    @abc.abstractmethod
    def scaled(self, size: float) -> "ServiceDistribution":
        """The service time of ``size`` units of data."""

    @abc.abstractmethod
    def sample(self, rng, shape):  # numpy rng
        """Draws of the given shape from a numpy Generator."""

    @abc.abstractmethod
    def mean(self) -> float:
        """E[T]."""

    @abc.abstractmethod
    def var(self) -> float:
        """Var[T]."""


@dataclasses.dataclass(frozen=True)
class Exponential(ServiceDistribution):
    """T ~ Exp(mu): P{T > t} = exp(-mu t)."""

    mu: float

    def __post_init__(self):
        if self.mu <= 0:
            raise ValueError(f"mu must be positive, got {self.mu}")

    def scaled(self, size: float) -> "Exponential":
        # size-dependent service: rate mu/size
        return Exponential(mu=self.mu / size)

    def sample(self, rng, shape):
        return rng.exponential(scale=1.0 / self.mu, size=shape)

    def cdf(self, t):
        """P{T <= t}, vectorized (used by the goodness-of-fit gate)."""
        t = np.asarray(t, dtype=float)
        return np.where(t > 0, -np.expm1(-self.mu * np.maximum(t, 0.0)), 0.0)

    def mean(self) -> float:
        return 1.0 / self.mu

    def var(self) -> float:
        return 1.0 / self.mu**2


@dataclasses.dataclass(frozen=True)
class ShiftedExponential(ServiceDistribution):
    """T ~ SExp(Delta, mu): P{T > t} = exp(-mu (t - Delta)) for t >= Delta."""

    delta: float
    mu: float

    def __post_init__(self):
        if self.mu <= 0:
            raise ValueError(f"mu must be positive, got {self.mu}")
        if self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")

    def scaled(self, size: float) -> "ShiftedExponential":
        return ShiftedExponential(delta=self.delta * size, mu=self.mu / size)

    def sample(self, rng, shape):
        return self.delta + rng.exponential(scale=1.0 / self.mu, size=shape)

    def cdf(self, t):
        """P{T <= t}, vectorized (used by the goodness-of-fit gate)."""
        t = np.asarray(t, dtype=float)
        z = np.maximum(t - self.delta, 0.0)
        return np.where(t > self.delta, -np.expm1(-self.mu * z), 0.0)

    def mean(self) -> float:
        return self.delta + 1.0 / self.mu

    def var(self) -> float:
        return 1.0 / self.mu**2


def _kaplan_meier(
    times: np.ndarray, censored: np.ndarray
) -> tuple[np.ndarray, np.ndarray, float]:
    """Product-limit curve: (death atoms, their KM masses, leftover survival).

    ``leftover`` is the survival mass beyond the largest uncensored time
    (positive when the largest observations are censored) — callers choose
    what to do with it: :meth:`Empirical.from_censored` collapses it onto
    the last atom (Efron's convention, finite moments), while the
    goodness-of-fit KS statistic leaves it out (the KM curve is simply not
    estimated past the last death, and folding the mass in would fabricate
    a jump no fit could match).

    Tie convention: deaths precede censorings at equal times (a same-time
    censored subject is still at risk for the death).
    """
    order = np.lexsort((censored, times))
    t, c = times[order], censored[order]
    n = t.size
    atoms: list[float] = []
    masses: list[float] = []
    survival = 1.0
    i = 0
    while i < n:
        j = i
        while j < n and t[j] == t[i] and c[j] == c[i]:
            j += 1
        if not c[i]:  # a group of tied deaths
            at_risk = n - i
            d = j - i
            new_survival = survival * (1.0 - d / at_risk)
            atoms.append(float(t[i]))
            masses.append(survival - new_survival)
            survival = new_survival
        i = j
    return np.asarray(atoms), np.asarray(masses), survival


@dataclasses.dataclass(frozen=True)
class Empirical(ServiceDistribution):
    """Empirical service distribution: a (weighted) ECDF over observed times.

    The paper's closed forms — and the parametric planners built on them —
    assume Exp/SExp service.  Real telemetry rarely fits either family, and
    the optimal replication level is driven by the *tail* of the actual
    distribution, which a two-parameter fit can badly misestimate
    (Behrouzi-Far & Soljanin, arXiv:2006.02318).  ``Empirical`` lets every
    downstream consumer (simulator sweeps, planners, the tuner) plan from
    what the fleet actually does:

    * ``atoms``   — observed unit-service times (sorted ascending on
      construction; pass them in any order).
    * ``weights`` — optional per-atom probability masses (normalized on
      construction; ``None`` = uniform).  Non-uniform weights arise from
      censoring-aware construction (:meth:`from_censored`, Kaplan-Meier).

    Sampling is inverse-CDF: ``ppf(u)`` returns the smallest atom whose
    cumulative weight reaches ``u``.  ``scaled(s)`` multiplies every atom by
    ``s`` — the same affine size-dependent load model the parametric
    families follow (``scaled(s) = s * unit_time`` for Exp/SExp too).

    >>> emp = Empirical((3.0, 1.0, 2.0))
    >>> emp.atoms
    (1.0, 2.0, 3.0)
    >>> emp.quantile(0.5)
    2.0
    >>> emp.scaled(2.0).mean()
    4.0
    """

    atoms: tuple[float, ...]
    weights: Optional[tuple[float, ...]] = None

    def __post_init__(self):
        arr = np.asarray(self.atoms, dtype=float).ravel()
        if arr.size == 0:
            raise ValueError("Empirical needs at least one atom")
        if np.any(~np.isfinite(arr)) or np.any(arr < 0):
            raise ValueError("atoms must be finite and non-negative")
        order = np.argsort(arr, kind="stable")
        object.__setattr__(self, "atoms", tuple(float(x) for x in arr[order]))
        if self.weights is not None:
            w = np.asarray(self.weights, dtype=float).ravel()
            if w.shape != arr.shape:
                raise ValueError(
                    f"weights shape {w.shape} != atoms shape {arr.shape}"
                )
            if np.any(~np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
                raise ValueError("weights must be non-negative with mass > 0")
            w = w[order] / w.sum()
            object.__setattr__(self, "weights", tuple(float(x) for x in w))

    @classmethod
    def from_censored(cls, times, censored=None) -> "Empirical":
        """Censoring-aware construction (Kaplan-Meier product-limit).

        ``censored[i]`` marks a RIGHT-censored observation: the true service
        time exceeds ``times[i]`` (a replica cancelled at its batch's first
        response — the tuner's telemetry).  The KM estimator redistributes
        each censored observation's mass over the larger uncensored times,
        so the fitted tail is unbiased where a naive ECDF of the recorded
        times would be biased LOW by exactly the censoring fraction.
        Mass beyond the largest uncensored time (when the largest
        observations are censored) follows Efron's convention: it collapses
        onto the largest uncensored atom, keeping moments finite.

        With no censoring this is exactly the ECDF of ``times``.
        """
        t = np.asarray(times, dtype=float).ravel()
        if t.size == 0:
            raise ValueError("at least one observation required")
        if np.any(~np.isfinite(t)) or np.any(t < 0):
            raise ValueError("times must be finite and non-negative")
        c = (
            np.zeros(t.shape, dtype=bool)
            if censored is None
            else np.asarray(censored, dtype=bool).ravel()
        )
        if c.shape != t.shape:
            raise ValueError("censored mask must match times shape")
        if c.all():
            raise ValueError("at least one uncensored observation required")
        atoms, masses, leftover = _kaplan_meier(t, c)
        if leftover > 0:  # largest observations censored: Efron tail
            masses = masses.copy()
            masses[-1] += leftover
        return cls(tuple(atoms), tuple(masses))

    # -- cached numpy views (cached_property writes to __dict__, which a
    # frozen dataclass still has — the fields themselves stay immutable)
    @functools.cached_property
    def _atoms_arr(self) -> np.ndarray:
        return np.asarray(self.atoms, dtype=float)

    @functools.cached_property
    def _cum_weights(self) -> np.ndarray:
        if self.weights is None:
            n = len(self.atoms)
            return np.arange(1, n + 1) / n
        cw = np.cumsum(np.asarray(self.weights, dtype=float))
        cw[-1] = 1.0  # kill the cumsum rounding at the top
        return cw

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    def scaled(self, size: float) -> "Empirical":
        # affine size model: serving s units takes s * (unit time), exactly
        # like the parametric families' scaled()
        return Empirical(
            tuple(a * size for a in self.atoms), weights=self.weights
        )

    def ppf(self, u):
        """Inverse ECDF: smallest atom with cumulative weight >= u."""
        u = np.asarray(u, dtype=float)
        idx = np.searchsorted(self._cum_weights, u, side="left")
        return self._atoms_arr[np.minimum(idx, self.n_atoms - 1)]

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return float(self.ppf(q))

    def cdf(self, t):
        """Weighted ECDF: P{T <= t}, vectorized."""
        t = np.asarray(t, dtype=float)
        idx = np.searchsorted(self._atoms_arr, t, side="right")
        cw = np.concatenate([[0.0], self._cum_weights])
        return cw[idx]

    def sample(self, rng, shape):
        """I.i.d. inverse-CDF draws.

        Consumes ``Exp(1)`` variates (mapped to uniforms via the
        probability-integral transform) rather than raw uniforms so the
        draw-stream convention matches the parametric families and the
        simulation engine's shared-CRN core.
        """
        u = -np.expm1(-rng.standard_exponential(shape))
        return self.ppf(u)

    def bootstrap(self, rng) -> "Empirical":
        """One bootstrap resample: n atoms redrawn by weight, uniform mass.

        The resampling unit of the bootstrap planner
        — planning over K of these propagates the SAMPLING uncertainty of
        the observation window into the B decision.
        """
        n = self.n_atoms
        idx = rng.choice(n, size=n, replace=True, p=self.weights)
        return Empirical(tuple(self._atoms_arr[idx]))

    def mean(self) -> float:
        if self.weights is None:
            return float(self._atoms_arr.mean())
        return float(self._atoms_arr @ np.asarray(self.weights))

    def var(self) -> float:
        m = self.mean()
        sq = (self._atoms_arr - m) ** 2
        if self.weights is None:
            return float(sq.mean())
        return float(sq @ np.asarray(self.weights))


def batch_service(dist: ServiceDistribution, n: int, b: int) -> ServiceDistribution:
    """Service distribution of one batch of size N/B under the size model."""
    if n % b:
        raise ValueError(f"B={b} must divide N={n}")
    return dist.scaled(n / b)


def completion_mean(dist: ServiceDistribution, n: int, b: int) -> float:
    """E[T(B)] for balanced non-overlapping replication (Thms 2 & 3)."""
    if n % b:
        raise ValueError(f"B={b} must divide N={n}")
    if isinstance(dist, ShiftedExponential):
        return n * dist.delta / b + harmonic(b) / dist.mu
    if isinstance(dist, Exponential):
        return harmonic(b) / dist.mu
    raise TypeError(f"unsupported distribution {dist!r}")


def completion_var(dist: ServiceDistribution, n: int, b: int) -> float:
    """Var[T(B)] for balanced non-overlapping replication (Thms 2 & 4).

    The exponential part of every batch-minimum is Exp(mu) regardless of B
    (rate mu*B/N, min over N/B replicas), so T - shift = max of B iid Exp(mu)
    whose variance is mu^-2 * sum_{k<=B} k^-2.
    """
    if n % b:
        raise ValueError(f"B={b} must divide N={n}")
    if isinstance(dist, (Exponential, ShiftedExponential)):
        return generalized_harmonic(b, 2) / dist.mu**2
    raise TypeError(f"unsupported distribution {dist!r}")


def completion_quantile(
    dist: ServiceDistribution, n: int, b: int, q: float
) -> float:
    """Quantile of T(B): shift + quantile of max of B iid Exp(mu).

    CDF of the max is (1 - e^{-mu t})^B, so t_q = -ln(1 - q^{1/B}) / mu.
    Used for p99-style tail guarantees (the paper motivates variance control
    via performance guarantees, Dean & Barroso 'tail at scale').
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0,1), got {q}")
    if n % b:
        raise ValueError(f"B={b} must divide N={n}")
    shift = 0.0
    if isinstance(dist, ShiftedExponential):
        shift = n * dist.delta / b
    elif not isinstance(dist, Exponential):
        raise TypeError(f"unsupported distribution {dist!r}")
    return shift - math.log(1.0 - q ** (1.0 / b)) / dist.mu


def expected_max_exponential(rates: Sequence[float]) -> float:
    """E[max of independent Exp(rate_i)] via inclusion-exclusion.

    E[max] = sum_{nonempty S} (-1)^{|S|+1} / sum_{i in S} rate_i.
    Exact; cost 2^len(rates), intended for len <= ~20 (policy comparisons).
    """
    rates = list(rates)
    if not rates or any(r <= 0 for r in rates):
        raise ValueError(f"rates must be positive and non-empty: {rates}")
    if len(rates) > 22:
        raise ValueError("inclusion-exclusion limited to <=22 rates")
    total = 0.0
    for k in range(1, len(rates) + 1):
        for subset in itertools.combinations(rates, k):
            total += (-1.0) ** (k + 1) / sum(subset)
    return total


def expected_max_min_groups(
    dist: ServiceDistribution, n: int, group_sizes: Iterable[int]
) -> float:
    """E[T] for a (possibly unbalanced) non-overlapping assignment.

    ``group_sizes[i]`` workers serve batch i; batches have equal size n/B
    (B = len(group_sizes)); sum(group_sizes) must equal n.  Used to verify
    Thm 1's 'balanced beats unbalanced' claim exactly for exponentials, and
    the shifted case decomposes as shift + exponential part only when the
    assignment is balanced — for unbalanced SExp we fall back to simulation
    (see core.simulator).
    """
    sizes = list(group_sizes)
    b = len(sizes)
    if sum(sizes) != n:
        raise ValueError(f"group sizes {sizes} must sum to N={n}")
    if any(g <= 0 for g in sizes):
        raise ValueError(f"group sizes must be positive: {sizes}")
    per_batch = batch_service(dist, n, b)
    if isinstance(dist, Exponential):
        # min over g_i replicas of Exp(mu*B/N) ~ Exp(g_i*mu*B/N)
        rates = [g * per_batch.mu for g in sizes]
        return expected_max_exponential(rates)
    if isinstance(dist, ShiftedExponential):
        # every batch has the same deterministic shift (equal batch sizes);
        # the exponential parts are Exp(g_i * mu * B / N)
        rates = [g * per_batch.mu for g in sizes]
        return per_batch.delta + expected_max_exponential(rates)
    raise TypeError(f"unsupported distribution {dist!r}")


def expected_completion_rates(
    dist: ServiceDistribution,
    n: int,
    worker_batch: Sequence[int],
    rates: Sequence[float],
) -> float:
    """E[T] for equal-size non-overlapping batches with HETEROGENEOUS workers.

    ``worker_batch[j]`` is the batch worker j serves; ``rates[j]`` is worker
    j's relative service rate (its exponential part runs at ``mu*rates[j]``).
    A batch of size n/B served by workers S has its fastest replica
    exponential with aggregate rate ``sum_{j in S} mu*rates[j] * B/n``, so
    E[T] is the expected max of B independent exponentials (plus the common
    deterministic shift for SExp).  Closed-form companion of the simulator's
    heterogeneous paths and the scoring function of
    ``policies.rate_aware_assignment``.
    """
    wb = list(worker_batch)
    rs = list(rates)
    if len(wb) != len(rs):
        raise ValueError("worker_batch and rates must have equal length")
    if len(wb) != n:
        raise ValueError(
            f"worker_batch has {len(wb)} workers but N={n} (the paper "
            "normalizes the fleet to one worker per data unit)"
        )
    if any(r <= 0 for r in rs):
        raise ValueError(f"rates must be positive: {rs}")
    b = max(wb) + 1
    if set(wb) != set(range(b)):
        raise ValueError("every batch must have at least one worker")
    if n % b:
        raise ValueError(f"B={b} must divide N={n}")
    per_batch = batch_service(dist, n, b)
    agg = [0.0] * b
    for j, batch in enumerate(wb):
        agg[batch] += rs[j] * per_batch.mu
    if isinstance(dist, Exponential):
        return expected_max_exponential(agg)
    if isinstance(dist, ShiftedExponential):
        return per_batch.delta + expected_max_exponential(agg)
    raise TypeError(f"unsupported distribution {dist!r}")
