"""MLE fitting of the service-time distribution from runtime telemetry.

The tuner observes per-worker step times.  Two complications vs textbook MLE:

* **Right censoring** — when the runtime cancels stragglers (or a step
  finishes because every batch has a fast replica), slow workers' times are
  only known to exceed the step's cutoff.  We support censored samples.
* **Model selection** — Exp vs SExp: we fit both and pick by (censored)
  log-likelihood with a small penalty for the extra parameter (AIC).
* **Goodness of fit** — a parametric family can be the better of two wrong
  answers.  :func:`goodness_of_fit` measures the censoring-aware
  Kolmogorov-Smirnov distance between the observation window (Kaplan-Meier
  ECDF) and a fitted distribution; the tuner uses it as the gate that
  switches re-planning onto the empirical path when both families are
  rejected by the data.

Shifted-exponential MLE (uncensored): Delta_hat = X_(1) (sample min),
mu_hat = 1 / (mean(X) - X_(1)).  We apply the standard small-sample
bias correction Delta_hat -= (mean - min)/(n-1) when requested.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .order_stats import (
    Exponential,
    ServiceDistribution,
    ShiftedExponential,
    _kaplan_meier as _km_curve,
)

__all__ = [
    "FitResult",
    "GofResult",
    "fit_exponential",
    "fit_shifted_exponential",
    "fit_best",
    "ks_critical",
    "ks_statistic",
    "goodness_of_fit",
]


@dataclasses.dataclass(frozen=True)
class FitResult:
    dist: ServiceDistribution
    log_likelihood: float
    n_samples: int
    n_censored: int

    @property
    def aic(self) -> float:
        k = 2 if isinstance(self.dist, ShiftedExponential) else 1
        return 2 * k - 2 * self.log_likelihood


def _validate(samples, censored):
    x = np.asarray(samples, dtype=float)
    if x.ndim != 1 or x.size == 0:
        raise ValueError("samples must be a non-empty 1-D array")
    if np.any(~np.isfinite(x)) or np.any(x < 0):
        raise ValueError("samples must be finite and non-negative")
    if censored is None:
        c = np.zeros(x.shape, dtype=bool)
    else:
        c = np.asarray(censored, dtype=bool)
        if c.shape != x.shape:
            raise ValueError("censored mask must match samples shape")
    if c.all():
        raise ValueError("at least one uncensored observation required")
    return x, c


def fit_exponential(samples, censored=None) -> FitResult:
    """Censored MLE for Exp(mu): mu_hat = n_uncensored / sum(all times)."""
    x, c = _validate(samples, censored)
    n_unc = int((~c).sum())
    total = float(x.sum())
    if total <= 0:
        raise ValueError("sum of observation times must be positive")
    mu = n_unc / total
    # log L = n_unc * log(mu) - mu * sum(x)   (censored terms contribute -mu*c_i)
    ll = n_unc * math.log(mu) - mu * total
    return FitResult(Exponential(mu=mu), ll, int(x.size), int(c.sum()))


def fit_shifted_exponential(
    samples, censored=None, bias_correct: bool = True
) -> FitResult:
    """Censored MLE for SExp(Delta, mu).

    Delta_hat = min over UNCENSORED observations (a censored time > Delta
    carries no extra information about the shift as long as it exceeds the
    min).  Given Delta, the exponential part uses the censored-Exp MLE on
    (x - Delta) clipped at 0 for censored entries that are below Delta
    (cannot happen for valid data, guarded anyway).
    """
    x, c = _validate(samples, censored)
    unc = x[~c]
    delta = float(unc.min())
    n_unc = int(unc.size)
    if bias_correct and n_unc > 1:
        excess_mean = float(unc.mean() - delta)
        delta = max(0.0, delta - excess_mean / (n_unc - 1))
    shifted = np.clip(x - delta, 0.0, None)
    total = float(shifted.sum())
    if total <= 0:
        # degenerate: all mass at the shift; fall back to a very fast rate
        mu = 1e12
    else:
        mu = n_unc / total
    ll = n_unc * math.log(mu) - mu * total
    return FitResult(
        ShiftedExponential(delta=delta, mu=mu), ll, int(x.size), int(c.sum())
    )


@dataclasses.dataclass(frozen=True)
class GofResult:
    """Outcome of a censoring-aware KS goodness-of-fit check.

    ``rejected`` compares the observed KS distance to the asymptotic
    critical value at ``alpha``.  The critical value assumes a FIXED null
    distribution; with fitted parameters the true test is anti-conservative
    (Lilliefors), which errs on the side of tripping the gate — the safe
    direction for a fallback to the empirical planner.
    """

    statistic: float  # sup |KM-ECDF - F_fit| over the observation window
    threshold: float  # critical KS distance at alpha
    n_effective: int  # uncensored observations driving the critical value
    alpha: float

    @property
    def rejected(self) -> bool:
        return self.statistic > self.threshold


def ks_critical(n: int, alpha: float = 0.01) -> float:
    """Asymptotic two-sided KS critical value ``sqrt(-ln(alpha/2) / (2n))``."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    return math.sqrt(-math.log(alpha / 2.0) / (2.0 * n))


def ks_statistic(samples, dist: ServiceDistribution, censored=None) -> float:
    """Censoring-aware KS distance between telemetry and ``dist``.

    The empirical side is the RAW Kaplan-Meier product-limit curve
    (:func:`~repro_torch.core.order_stats._kaplan_meier`), so right-censored
    observations inform the at-risk counts without biasing the ECDF low;
    the distance is the sup over both sides of every KM jump against
    ``dist.cdf``.  Survival mass beyond the largest death is excluded on
    purpose: the KM curve is not estimated there, and Efron's
    tail-collapse convention (used by ``Empirical.from_censored`` to keep
    moments finite) would fabricate a final jump that no well-fitting
    distribution could match.
    """
    x, c = _validate(samples, censored)
    atoms, masses, _ = _km_curve(x, c)
    cum = np.cumsum(masses)
    cdf = getattr(dist, "cdf", None)
    if cdf is None:
        raise TypeError(
            f"{type(dist).__name__} exposes no cdf(); cannot run the KS gate"
        )
    f = np.asarray(cdf(atoms), dtype=float)
    return float(
        np.max(np.maximum(np.abs(f - cum), np.abs(f - (cum - masses))))
    )


def goodness_of_fit(
    samples, dist: ServiceDistribution, censored=None, alpha: float = 0.01
) -> GofResult:
    """KS distance + accept/reject verdict at ``alpha`` (see GofResult)."""
    x, c = _validate(samples, censored)
    n_unc = int((~c).sum())
    return GofResult(
        statistic=ks_statistic(x, dist, c),
        threshold=ks_critical(n_unc, alpha),
        n_effective=n_unc,
        alpha=alpha,
    )


def fit_best(samples, censored=None) -> FitResult:
    """Fit both families, return the lower-AIC one.

    A fitted SExp with Delta ~ 0 collapses to Exp; the AIC penalty breaks the
    tie toward the 1-parameter family.
    """
    fe = fit_exponential(samples, censored)
    try:
        fs = fit_shifted_exponential(samples, censored)
    except ValueError:
        return fe
    return fs if fs.aic < fe.aic else fe
