"""The diversity–parallelism spectrum optimizer (Thms 2–4, Fig. 2).

Given N workers and a fitted service distribution, choose the number of
batches B (equivalently the replication factor r = N/B):

* B = 1  -> full diversity (everything replicated everywhere)
* B = N  -> full parallelism (no replication)

For SExp the expected completion time  E[T](B) = N*Delta/B + H_B/mu  has an
interior optimum governed by the product Delta*mu (paper Fig. 2); for Exp the
optimum is B=1 (Thm 2); the variance is minimized at B=1 for both (Thm 4) —
so mean-optimal and variance-optimal B generally DIFFER, which is the paper's
trade-off headline.  :func:`optimize` exposes all of it.

:func:`sweep` is closed-form (homogeneous Exp/SExp); :func:`sweep_simulated`
is its Monte-Carlo twin on the batched ``simulator.sweep_simulate`` engine —
one call per re-plan, common random numbers across B, and support for
heterogeneous per-worker rates.  The simulated sweep runs on a torch
``device`` (default ``"cuda"``; pass ``"cpu"`` explicitly for the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

import numpy as np

from .order_stats import (
    ServiceDistribution,
    ShiftedExponential,
    completion_mean,
    completion_quantile,
    completion_var,
)
from .policies import divisors

__all__ = [
    "Metric",
    "METRICS",
    "metric_value",
    "point_from_samples",
    "result_from_points",
    "SpectrumPoint",
    "SpectrumResult",
    "sweep",
    "sweep_simulated",
    "optimize",
    "continuous_optimum",
]

# THE shared metric vocabulary of the control plane.  Every layer that picks
# a B (planner, tuner, elastic rescale, fault recovery, serving) accepts the
# same four literals; ``metric_value`` is the one place they are interpreted.
Metric = Literal["mean", "var", "p99", "p999"]
METRICS: tuple[str, ...] = ("mean", "var", "p99", "p999")


@dataclasses.dataclass(frozen=True)
class SpectrumPoint:
    n_batches: int
    replication: int
    mean: float
    var: float
    p99: float
    p999: float = math.nan

    @property
    def std(self) -> float:
        return math.sqrt(self.var)


def metric_value(point: SpectrumPoint, metric: Metric) -> float:
    """Read the requested objective metric off a spectrum point."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (expected one of {METRICS})")
    v = float(getattr(point, metric))
    if math.isnan(v):
        # a hand-built point left p999 at its default — NaN would silently
        # poison any argmin (all NaN comparisons are False), so fail loudly
        raise ValueError(f"metric {metric!r} is NaN on {point!r}")
    return v


def point_from_samples(
    n_batches: int, replication: int, samples: np.ndarray
) -> SpectrumPoint:
    """Empirical SpectrumPoint from Monte-Carlo completion-time samples —
    the ONE place the sample statistics are defined (shared by
    :func:`sweep_simulated` and the planner's rate-aware sweep)."""
    s = np.asarray(samples)
    return SpectrumPoint(
        n_batches=n_batches,
        replication=replication,
        mean=float(s.mean()),
        var=float(s.var(ddof=1)),
        p99=float(np.quantile(s, 0.99)),
        p999=float(np.quantile(s, 0.999)),
    )


def result_from_points(points: Sequence[SpectrumPoint]) -> SpectrumResult:
    """Assemble a SpectrumResult (argmin fields included) from points."""
    pts = tuple(points)
    if not pts:
        raise ValueError("at least one spectrum point required")
    return SpectrumResult(
        points=pts,
        best_mean=min(pts, key=lambda p: p.mean),
        best_var=min(pts, key=lambda p: p.var),
        best_p99=min(pts, key=lambda p: p.p99),
    )


@dataclasses.dataclass(frozen=True)
class SpectrumResult:
    points: tuple[SpectrumPoint, ...]
    best_mean: SpectrumPoint
    best_var: SpectrumPoint
    best_p99: SpectrumPoint

    @property
    def tradeoff(self) -> bool:
        """True when the mean-optimal and var-optimal B differ (paper §III)."""
        return self.best_mean.n_batches != self.best_var.n_batches

    def pareto_front(self) -> tuple[SpectrumPoint, ...]:
        """Non-dominated (mean, var) points, ascending in mean."""
        pts = sorted(self.points, key=lambda p: (p.mean, p.var))
        front: list[SpectrumPoint] = []
        best_var = math.inf
        for p in pts:
            if p.var < best_var - 1e-15:
                front.append(p)
                best_var = p.var
        return tuple(front)

    def best(self, metric: Metric) -> SpectrumPoint:
        """argmin over the sweep for ANY shared metric (incl. p999)."""
        return min(self.points, key=lambda p: metric_value(p, metric))

    def at(self, n_batches: int) -> SpectrumPoint:
        """The point for a specific B (raises KeyError if not swept)."""
        for p in self.points:
            if p.n_batches == n_batches:
                return p
        raise KeyError(f"B={n_batches} not in sweep {[p.n_batches for p in self.points]}")


def sweep(
    dist: ServiceDistribution,
    n_workers: int,
    feasible_b: Sequence[int] | None = None,
) -> SpectrumResult:
    """Evaluate every feasible B (divisors of N by default) in closed form."""
    bs = list(feasible_b) if feasible_b is not None else divisors(n_workers)
    if not bs:
        raise ValueError("no feasible B values")
    pts = []
    for b in bs:
        if n_workers % b:
            raise ValueError(f"B={b} infeasible: must divide N={n_workers}")
        pts.append(
            SpectrumPoint(
                n_batches=b,
                replication=n_workers // b,
                mean=completion_mean(dist, n_workers, b),
                var=completion_var(dist, n_workers, b),
                p99=completion_quantile(dist, n_workers, b, 0.99),
                p999=completion_quantile(dist, n_workers, b, 0.999),
            )
        )
    return result_from_points(pts)


def sweep_simulated(
    dist: ServiceDistribution,
    n_workers: int,
    feasible_b: Sequence[int] | None = None,
    n_trials: int = 8_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    device=None,
) -> SpectrumResult:
    """Monte-Carlo twin of :func:`sweep`, one batched engine call.

    Where the closed forms of :func:`sweep` only cover homogeneous Exp/SExp,
    this path also handles heterogeneous per-worker ``rates`` — the tuner
    uses it for online re-planning when the fleet is skewed — and ANY
    distribution the engine samples, including telemetry-fitted
    :class:`~repro_torch.core.order_stats.Empirical` ECDFs (quantile-coupled to
    the shared draws).  All B cells share one draw matrix (common random
    numbers via ``simulator.sweep_simulate``), so the argmin across B is
    far less noisy than independent simulations would be.
    """
    from .simulator import sweep_simulate  # local: avoid import cycle

    res = sweep_simulate(
        dist,
        n_workers,
        n_trials=n_trials,
        seed=seed,
        feasible_b=feasible_b,
        rates=rates,
        device=device,
    )
    return result_from_points(
        point_from_samples(b, n_workers // b, res.samples[0, i])
        for i, b in enumerate(res.splits)
    )


def optimize(
    dist: ServiceDistribution,
    n_workers: int,
    metric: Metric = "mean",
    feasible_b: Sequence[int] | None = None,
) -> SpectrumPoint:
    """argmin_B of the requested metric over feasible B (Thm 3 Eq. (4)).

    .. deprecated::
        Legacy single-shot entry point, kept as a compatibility shim.  New
        code should go through the unified control plane:
        ``AnalyticPlanner().plan(ClusterSpec(n_workers, dist), Objective(metric))``
        (see :mod:`repro_torch.core.planner`), which returns the full
        :class:`~repro_torch.core.planner.Plan` (assignment + predicted metrics)
        instead of a bare point.
    """
    return sweep(dist, n_workers, feasible_b).best(metric)


def continuous_optimum(dist: ShiftedExponential, n_workers: int) -> float:
    """Continuous relaxation of Thm 3: treating H_B ~ ln B + gamma,
    d/dB [N Delta / B + (ln B + gamma)/mu] = 0  =>  B* = N * Delta * mu.

    Clipped to [1, N].  Useful as a sanity anchor for the discrete argmin and
    to expose the paper's 'larger Delta*mu -> more parallelism' monotonicity.
    """
    if not isinstance(dist, ShiftedExponential):
        raise TypeError("continuous optimum defined for SExp only (Exp -> B*=1)")
    b_star = n_workers * dist.delta * dist.mu
    return min(max(b_star, 1.0), float(n_workers))
