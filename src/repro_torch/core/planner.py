"""Unified planner: one ``ClusterSpec -> Plan`` control plane, on a device.

The port of ``repro.core.planner``.  The paper's
result is a single decision — factor N workers into (B batches x r
replicas) under a fitted service distribution — and every runtime layer
describes its fleet as a :class:`ClusterSpec`, states what it cares about
as an :class:`Objective`, and receives a :class:`Plan`:

    plan = SimulatedPlanner().plan(ClusterSpec(n_workers=16, dist=dist),
                                   Objective(metric="p99"))
    plan.n_batches        # the chosen B
    plan.assignment       # a concrete worker->batch placement
    plan.predicted        # SpectrumPoint(mean/var/p99/p999) at the chosen B
    plan.spectrum         # the full sweep (for hysteresis comparisons)

Four implementations of the :class:`Planner` strategy:

* :class:`AnalyticPlanner` — closed-form sweep (Thms 2-4); homogeneous
  Exp/SExp only.
* :class:`SimulatedPlanner` — the batched CRN sweeps of
  :mod:`repro_torch.core.simulator` on a torch ``device`` (default
  ``"cuda"``, which must be present; ``"cpu"`` on request): batch
  completion, load-aware sojourn, speculative triggers, the straggler-
  policy portfolio, coded candidates and, for ``Objective.slo_classes``,
  the multi-tenant serving sweep (per-request latencies of every (B,
  policy, max_wait, shed) cell, ranked feasibility-first).
* :class:`HeterogeneousPlanner` — the rate-aware extension: every
  candidate B scored under the ``rate_aware_assignment`` placement it
  emits, with per-worker ``rates``, one per-B simulation a B on one seed
  (the coverage rule, or one ``sojourn_cells`` launch a B when the
  objective is load-aware), plus the closed-form
  ``expected_completion_rates`` companion.  On a homogeneous spec it is
  :class:`SimulatedPlanner`.
* :class:`EmpiricalPlanner` — plans over K bootstrap resamples of an
  :class:`~repro_torch.core.order_stats.Empirical` distribution (the
  resamples ride the dists axis of one sweep), picks B* by majority vote
  of the per-resample argmins, and reports the vote as
  :attr:`Plan.confidence` / :attr:`Plan.vote_share`.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from ..device import device_name, resolve_device
from .coding import CodingCandidate
from .estimator import FitResult
from .order_stats import (
    Empirical,
    Exponential,
    ServiceDistribution,
    ShiftedExponential,
    expected_completion_rates,
)
from .policies import (
    Assignment,
    PolicyCandidate,
    ShedPolicy,
    SloClass,
    _validate_rates,
    divisors,
    rate_aware_assignment,
    replica_major_nonoverlapping,
)
from .replication import ReplicationPlan
from .spectrum import (
    METRICS,
    Metric,
    SpectrumPoint,
    SpectrumResult,
    metric_value,
    point_from_samples,
    result_from_points,
    sweep,
    sweep_simulated,
)

__all__ = [
    "ClusterSpec",
    "Objective",
    "Plan",
    "Planner",
    "AnalyticPlanner",
    "SimulatedPlanner",
    "HeterogeneousPlanner",
    "EmpiricalPlanner",
    "make_planner",
]

# expected_completion_rates runs inclusion-exclusion over B aggregate rates
# (2^B terms); beyond this B we skip the closed-form companion.
_CLOSED_FORM_MAX_BATCHES = 16


def _best_speculative_point(
    n_batches: int,
    replication: int,
    sample_sets: Sequence[np.ndarray],
    quantiles: Sequence[Optional[float]],
    metric: Metric,
    feasible: Optional[Sequence[bool]] = None,
) -> tuple[SpectrumPoint, Optional[float]]:
    """Pick one B's best candidate: build a SpectrumPoint per candidate
    sample set and return the (point, label) minimizing the objective
    metric.  Label-generic — ``quantiles`` holds clone triggers on the
    legacy speculation axis (None = plain replication) and
    :class:`~repro_torch.core.policies.PolicyCandidate` objects on the policy
    axis.

    ``feasible`` masks candidates that fail the stability gate (charged
    utilization >= 1 once the policy's redundant work is accounted): an
    infeasible candidate can look great over a finite simulation window —
    its queue simply has not diverged yet — so it may never win the argmin.
    When EVERY candidate is infeasible the mask is ignored (the sweep must
    still emit a point; the caller's feasibility report carries the bad
    news)."""
    candidates = [
        point_from_samples(n_batches, replication, s) for s in sample_sets
    ]
    indices: Sequence[int] = range(len(candidates))
    if feasible is not None and any(feasible):
        indices = [i for i in indices if feasible[i]]
    best = min(
        indices,
        key=lambda qi: metric_value(candidates[qi], metric),
    )
    return candidates[best], quantiles[best]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Everything the control plane knows about the fleet.

    * ``n_workers``     — the paper's N.
    * ``dist``          — fitted service distribution of ONE unit of data on
                          one nominal worker (from :mod:`repro_torch.core.estimator`
                          or ground truth).
    * ``rates``         — optional per-worker relative service rates (higher
                          = faster; None = homogeneous fleet).
    * ``feasible_b``    — explicit candidate B values (default: all divisors
                          of N).
    * ``batch_divisor`` — if set, B must also divide it (e.g. the global
                          batch size, so every data batch has integer rows).
    * ``max_batches``   — if set, B may not exceed it (e.g. "never exceed the
                          pre-fault B" during recovery).

    >>> spec = ClusterSpec(n_workers=16, dist=ShiftedExponential(0.5, 2.0),
    ...                    batch_divisor=8)
    >>> spec.feasible_batches()
    (1, 2, 4, 8)
    """

    n_workers: int
    dist: ServiceDistribution
    rates: Optional[tuple[float, ...]] = None
    feasible_b: Optional[tuple[int, ...]] = None
    batch_divisor: Optional[int] = None
    max_batches: Optional[int] = None

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.rates is not None:
            r = _validate_rates(self.rates, self.n_workers)
            object.__setattr__(self, "rates", tuple(float(x) for x in r))
        if self.feasible_b is not None:
            object.__setattr__(
                self, "feasible_b", tuple(int(b) for b in self.feasible_b)
            )
        if not self.feasible_batches():
            raise ValueError(
                f"no feasible B for N={self.n_workers} under "
                f"feasible_b={self.feasible_b} batch_divisor={self.batch_divisor} "
                f"max_batches={self.max_batches}"
            )

    @classmethod
    def from_fit(
        cls,
        fit: FitResult,
        n_workers: int,
        rates: Optional[Sequence[float]] = None,
        **constraints,
    ) -> "ClusterSpec":
        """Spec from an estimator fit + optional per-worker rate estimates."""
        return cls(
            n_workers=n_workers,
            dist=fit.dist,
            rates=tuple(float(r) for r in rates) if rates is not None else None,
            **constraints,
        )

    @property
    def heterogeneous(self) -> bool:
        """True when per-worker rates are present AND actually skewed."""
        return self.rates is not None and any(
            r != self.rates[0] for r in self.rates
        )

    @property
    def has_skewed_rates(self) -> bool:
        """Alias of :attr:`heterogeneous` (the name capability checks and
        error messages use: 'this spec carries rate skew a planner must
        either consume or explicitly reject')."""
        return self.heterogeneous

    def feasible_batches(self) -> tuple[int, ...]:
        """Candidate B values after applying every constraint."""
        base = self.feasible_b if self.feasible_b is not None else tuple(
            divisors(self.n_workers)
        )
        return tuple(
            b
            for b in base
            if b >= 1
            and self.n_workers % b == 0
            and (self.batch_divisor is None or self.batch_divisor % b == 0)
            and (self.max_batches is None or b <= self.max_batches)
        )

    def drop_slowest(self, n_lost: int) -> tuple["ClusterSpec", tuple[int, ...]]:
        """The surviving fleet after shedding ``n_lost`` workers.

        With known ``rates`` the n_lost SLOWEST (lowest-rate) workers are
        dropped — shrinking should shed stragglers, not arbitrary ids — and
        their indices are returned.  Without rates the fleet just shrinks
        (ids unknowable, empty tuple returned).  Surviving rates keep their
        original values: they are multipliers on ``dist``'s rate, so
        renormalizing would silently re-scale every prediction.  Explicit
        ``feasible_b`` is reset (its entries need not divide the new N).
        """
        if not 0 <= n_lost < self.n_workers:
            raise ValueError(
                f"n_lost={n_lost} out of range for N={self.n_workers}"
            )
        if n_lost == 0:
            return self, ()
        n_new = self.n_workers - n_lost
        if self.rates is None:
            return (
                dataclasses.replace(self, n_workers=n_new, feasible_b=None),
                (),
            )
        order = np.argsort(np.asarray(self.rates), kind="stable")
        dropped = tuple(sorted(int(j) for j in order[:n_lost]))
        survivors = [j for j in range(self.n_workers) if j not in set(dropped)]
        new_rates = tuple(self.rates[j] for j in survivors)
        return (
            dataclasses.replace(
                self, n_workers=n_new, rates=new_rates, feasible_b=None
            ),
            dropped,
        )


@dataclasses.dataclass(frozen=True)
class Objective:
    """What to optimize, plus the re-plan trigger's hysteresis knobs.

    ``metric`` uses the ONE shared :data:`~repro_torch.core.spectrum.Metric`
    vocabulary.  ``improvement_threshold`` (fraction in [0, 1)) and
    ``cooldown_steps`` are read by re-plan triggers (tuner, serving engine):
    moving B is not free — it flushes compiled executables and reshuffles
    the data pipeline — so only move for real wins.

    **Load-aware objectives.**  With ``arrival_rate`` (batch-jobs per unit
    time) or ``utilization`` (offered load as a fraction of the fleet's
    no-replication capacity) set, the metric is evaluated on per-request
    SOJOURN time (queue wait + service) under Poisson arrivals instead of
    batch-completion time — redundancy decisions flip sign under queueing
    load (Aktaş et al.; Peng et al.), and this is where the planner sees it.
    ``job_load`` is the units of data one batch-job carries (constant in B:
    a serving batch is ``max_batch_size`` requests no matter how the fleet
    is factored).  Only simulated planners can score load-aware objectives.

    **Speculative re-dispatch.**  ``speculation_quantiles`` (load-aware
    objectives only) asks the simulated planners to also score each
    candidate B WITH a clone-attack trigger at each listed late-quantile —
    a job whose first response is later than that quantile of its service
    distribution grabs an idle replica-set for one speculative clone
    (:func:`~repro_torch.core.simulator.sweep_sojourn_speculative`).  The plan
    then carries the winning trigger as
    :attr:`Plan.speculation_quantile` (``None`` when plain replication won).

    **Straggler-policy portfolio.**  ``policies`` (load-aware objectives
    only; mutually exclusive with ``speculation_quantiles``) asks the
    simulated planners to score each candidate B under each listed
    :class:`~repro_torch.core.policies.PolicyCandidate` — clone vs relaunch vs
    hedged vs none, one batched CRN call
    (:func:`~repro_torch.core.simulator.sweep_sojourn_policies`) — and the plan
    carries the winning candidate as :attr:`Plan.policy`.  A ``'none'``
    baseline is prepended automatically when absent, so "do nothing" always
    competes.

    **Coded alternatives.**  ``coding`` asks the simulated planners to also
    score each listed :class:`~repro_torch.core.coding.CodingCandidate` — cyclic
    gradient coding / MDS / polynomial-coded matmul at straggler tolerance
    ``s`` — against every replication split, all on the SAME shared CRN
    draw matrix (:func:`~repro_torch.core.simulator.sweep_coded` /
    :func:`~repro_torch.core.simulator.sweep_sojourn_coded`).  Candidates whose
    encode/decode overheads are ``None`` get them MEASURED (wall-clock,
    :func:`~repro_torch.kernels.coded.measure_coding_overhead`) before scoring,
    so coding never wins by assuming its fixed costs free.  The winner — if
    it strictly beats every replication split — lands on
    :attr:`Plan.coding`; works for both batch-completion and load-aware
    objectives.

    **Arrival process.**  ``arrivals`` (load-aware objectives only) carries
    the serving engine's ACTUAL arrival offsets (MMPP / bursty / trace)
    into every sojourn sweep — without it the planner silently scores
    Poisson arrivals the engine never runs (the bug this field fixes).
    Offsets shorter than the sweep's job count are cycled trace-style.
    For serving objectives (``slo_classes``) the offsets are per-REQUEST
    arrival times.

    **Multi-tenant serving.**  ``slo_classes`` (load-aware objectives only;
    requires ``batch_size``) switches :class:`SimulatedPlanner` into the
    per-request serving sweep (:func:`~repro_torch.core.simulator.
    sweep_sojourn_serving`): requests carrying per-class SLO deadlines are
    batch-formed by a weighted-fair-share master and every
    (B, policy, max_wait, shed) cell is scored on the same shared-CRN draw
    matrix.  ``max_waits`` makes the master's batch-formation timeout a
    co-optimization axis; ``sheds`` lists the admission-control /
    load-shedding candidates (a ``ShedPolicy('none')`` baseline is
    prepended automatically, so "shed nothing" always competes).  A cell is
    FEASIBLE only when every class's ``miss_target`` holds (shed requests
    count as misses); the winner is picked feasibility-first, then by the
    class-weighted objective metric over served requests, and lands on
    :attr:`Plan.policy` / :attr:`Plan.max_wait` / :attr:`Plan.shed` with a
    per-class miss report in :attr:`Plan.class_report`.  Mutually exclusive
    with ``speculation_quantiles`` and ``coding``.

    >>> Objective(metric="p99", utilization=0.7).load_aware
    True
    >>> Objective(metric="mean").load_aware
    False
    """

    metric: Metric = "mean"
    improvement_threshold: float = 0.0
    cooldown_steps: int = 0
    arrival_rate: Optional[float] = None
    utilization: Optional[float] = None
    job_load: float = 1.0
    speculation_quantiles: Optional[tuple[float, ...]] = None
    policies: Optional[tuple[PolicyCandidate, ...]] = None
    arrivals: Optional[tuple[float, ...]] = None
    coding: Optional[tuple[CodingCandidate, ...]] = None
    slo_classes: Optional[tuple[SloClass, ...]] = None
    batch_size: Optional[int] = None
    max_waits: Optional[tuple[float, ...]] = None
    sheds: Optional[tuple[ShedPolicy, ...]] = None

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown metric {self.metric!r} (expected one of {METRICS})"
            )
        if not 0.0 <= self.improvement_threshold < 1.0:
            raise ValueError(
                f"improvement_threshold must be in [0, 1), got "
                f"{self.improvement_threshold}"
            )
        if self.cooldown_steps < 0:
            raise ValueError(
                f"cooldown_steps must be >= 0, got {self.cooldown_steps}"
            )
        if self.arrival_rate is not None and self.utilization is not None:
            raise ValueError(
                "give arrival_rate OR utilization, not both (utilization is "
                "converted to an arrival rate against the spec's capacity)"
            )
        if self.arrival_rate is not None and not self.arrival_rate > 0:
            raise ValueError(
                f"arrival_rate must be positive, got {self.arrival_rate}"
            )
        if self.utilization is not None and not 0.0 < self.utilization < 1.0:
            raise ValueError(
                f"utilization must be in (0, 1), got {self.utilization}"
            )
        if not self.job_load > 0:
            raise ValueError(f"job_load must be positive, got {self.job_load}")
        if self.speculation_quantiles is not None:
            object.__setattr__(
                self,
                "speculation_quantiles",
                tuple(float(q) for q in self.speculation_quantiles),
            )
            if not self.speculation_quantiles:
                raise ValueError(
                    "speculation_quantiles must be non-empty when given"
                )
            for q in self.speculation_quantiles:
                if not 0.0 < q < 1.0:
                    raise ValueError(
                        f"speculation quantiles must be in (0, 1), got {q}"
                    )
            if not self.load_aware:
                raise ValueError(
                    "speculation_quantiles needs a load-aware objective "
                    "(arrival_rate or utilization): speculation is scored "
                    "on sojourn under queueing"
                )
        if self.policies is not None:
            if self.speculation_quantiles is not None:
                raise ValueError(
                    "give policies OR speculation_quantiles, not both — a "
                    "clone trigger is expressed as "
                    "PolicyCandidate('clone', quantile=q) on the policy axis"
                )
            pols = tuple(self.policies)
            if not pols:
                raise ValueError("policies must be non-empty when given")
            for p in pols:
                if not isinstance(p, PolicyCandidate):
                    raise TypeError(
                        "policies entries must be PolicyCandidate, got "
                        f"{type(p).__name__}"
                    )
            if not any(p.kind == "none" for p in pols):
                # 'do nothing' always competes: the argmin over the policy
                # axis must be able to reject every intervention
                pols = (PolicyCandidate(), *pols)
            object.__setattr__(self, "policies", pols)
            if not self.load_aware:
                raise ValueError(
                    "policies needs a load-aware objective (arrival_rate or "
                    "utilization): straggler policies are scored on sojourn "
                    "under queueing"
                )
        if self.coding is not None:
            cands = tuple(self.coding)
            if not cands:
                raise ValueError("coding must be non-empty when given")
            for c in cands:
                if not isinstance(c, CodingCandidate):
                    raise TypeError(
                        "coding entries must be CodingCandidate, got "
                        f"{type(c).__name__}"
                    )
            object.__setattr__(self, "coding", cands)
        if self.arrivals is not None:
            arr = np.asarray(self.arrivals, dtype=float)
            if arr.ndim != 1 or arr.size == 0:
                raise ValueError("arrivals must be a non-empty 1-D sequence")
            if np.any(~np.isfinite(arr)) or np.any(np.diff(arr) < 0):
                raise ValueError("arrivals must be finite and non-decreasing")
            object.__setattr__(
                self, "arrivals", tuple(float(t) for t in arr)
            )
            if not self.load_aware:
                raise ValueError(
                    "arrivals needs a load-aware objective (arrival_rate or "
                    "utilization): arrival offsets only matter for sojourn "
                    "scoring"
                )
        if self.slo_classes is not None:
            classes = tuple(self.slo_classes)
            if not classes:
                raise ValueError("slo_classes must be non-empty when given")
            for c in classes:
                if not isinstance(c, SloClass):
                    raise TypeError(
                        "slo_classes entries must be SloClass, got "
                        f"{type(c).__name__}"
                    )
            names = [c.name for c in classes]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate SLO class names in {names}")
            object.__setattr__(self, "slo_classes", classes)
            if not self.load_aware:
                raise ValueError(
                    "slo_classes needs a load-aware objective (arrival_rate "
                    "or utilization): tenant classes are scored on "
                    "per-request sojourn under queueing"
                )
            if self.batch_size is None:
                raise ValueError(
                    "slo_classes needs batch_size (requests per batch-job): "
                    "the serving sweep forms request batches"
                )
            if self.speculation_quantiles is not None:
                raise ValueError(
                    "slo_classes is incompatible with the legacy "
                    "speculation_quantiles axis — express clone triggers as "
                    "PolicyCandidate('clone', quantile=q) in policies"
                )
            if self.coding is not None:
                raise ValueError(
                    "slo_classes cannot be combined with coding candidates "
                    "(the coded sweep has no per-request serving mode yet)"
                )
        if self.batch_size is not None:
            if self.slo_classes is None:
                raise ValueError("batch_size requires slo_classes")
            if int(self.batch_size) < 1:
                raise ValueError(
                    f"batch_size must be >= 1, got {self.batch_size}"
                )
            object.__setattr__(self, "batch_size", int(self.batch_size))
        if self.max_waits is not None:
            if self.slo_classes is None:
                raise ValueError("max_waits requires slo_classes")
            waits = tuple(float(w) for w in self.max_waits)
            if not waits:
                raise ValueError("max_waits must be non-empty when given")
            for w in waits:
                if not w > 0 or math.isnan(w):
                    raise ValueError(
                        f"max_waits entries must be positive, got {w}"
                    )
            object.__setattr__(self, "max_waits", waits)
        if self.sheds is not None:
            if self.slo_classes is None:
                raise ValueError("sheds requires slo_classes")
            sheds = tuple(self.sheds)
            if not sheds:
                raise ValueError("sheds must be non-empty when given")
            for s in sheds:
                if not isinstance(s, ShedPolicy):
                    raise TypeError(
                        "sheds entries must be ShedPolicy, got "
                        f"{type(s).__name__}"
                    )
            if not any(s.kind == "none" for s in sheds):
                # 'shed nothing' always competes, mirroring the policy axis
                sheds = (ShedPolicy(), *sheds)
            object.__setattr__(self, "sheds", sheds)

    @property
    def load_aware(self) -> bool:
        """True when the metric applies to sojourn under queueing load."""
        return self.arrival_rate is not None or self.utilization is not None

    def offered_rate(
        self,
        spec: "ClusterSpec",
        policy: Optional[PolicyCandidate] = None,
    ) -> float:
        """The batch-job arrival rate this objective describes.

        ``utilization`` is anchored to the NO-REPLICATION capacity — N
        server groups each serving one ``job_load``-sized batch at a time —
        so a single utilization number compares fairly across candidate B
        (replication trades that capacity for lighter service tails).

        ``policy`` charges that candidate's expected redundant work
        (:meth:`~repro_torch.core.policies.PolicyCandidate.work_factor`): a
        clone/hedged policy dispatches extra replica sets that consume real
        capacity, so the rate that holds ``utilization`` UNDER that policy
        is lower by the work factor.  Without it the conversion silently
        scored redundant cells at the no-redundancy rate — the optimistic
        bias this argument fixes.  An explicit ``arrival_rate`` is returned
        verbatim (the caller pinned the load; feasibility is then the
        :meth:`charged_utilization` gate's job).
        """
        if self.arrival_rate is not None:
            return self.arrival_rate
        if self.utilization is None:
            raise ValueError("objective has no load (arrival_rate/utilization)")
        mean_service = spec.dist.scaled(self.job_load).mean()
        rate = self.utilization * spec.n_workers / mean_service
        if policy is not None:
            rate /= policy.work_factor(spec.dist.scaled(self.job_load))
        return rate

    def charged_utilization(
        self,
        spec: "ClusterSpec",
        policy: Optional[PolicyCandidate] = None,
    ) -> float:
        """Offered load as a fraction of fleet capacity AFTER charging the
        policy's expected redundant work.

        This is the stability gate's number: a sweep cell whose charged
        utilization reaches 1 has no steady state — its finite-window
        sojourn samples are a mirage — so the planners mark it infeasible
        regardless of how good the samples look.
        """
        mean_service = spec.dist.scaled(self.job_load).mean()
        util = self.offered_rate(spec) * mean_service / spec.n_workers
        if policy is not None:
            util *= policy.work_factor(spec.dist.scaled(self.job_load))
        return util

    def request_rate(self, spec: "ClusterSpec") -> float:
        """Per-REQUEST arrival rate of a serving objective.

        ``arrival_rate`` / ``utilization`` keep their batch-JOB semantics
        everywhere (one job = ``batch_size`` requests), so the serving
        sweep's request process is the job rate scaled by the batch size.
        """
        if self.batch_size is None:
            raise ValueError("request_rate needs slo_classes + batch_size")
        return self.offered_rate(spec) * self.batch_size


@dataclasses.dataclass(frozen=True)
class Plan:
    """The planner's decision: factoring + placement + predicted metrics.

    ``speculation_quantile`` is the late-quantile clone trigger the planner
    chose for the emitted B (only when the Objective offered
    ``speculation_quantiles``); ``None`` means plain replication scored
    best and the serving engine should not speculate.

    ``policy`` is the winning :class:`~repro_torch.core.policies.PolicyCandidate`
    at the emitted B (only when the Objective offered ``policies``); a
    ``kind='none'`` candidate means every intervention lost to plain
    replication.  When a clone candidate wins, ``speculation_quantile``
    mirrors its trigger so pre-portfolio consumers keep working.

    ``confidence`` and ``vote_share`` are the bootstrap-uncertainty report
    of :class:`EmpiricalPlanner` (None from every other planner):
    ``vote_share`` maps each swept B to the fraction of bootstrap
    resamples whose argmin landed there, and ``confidence`` is that
    fraction at the emitted B* — a plan with confidence 0.5 says the
    observation window genuinely cannot distinguish the top candidates,
    which is exactly when hysteresis should keep the fleet where it is.

    ``backend`` is the device that actually scored this plan (``"cuda"`` or
    ``"cpu"``) — provenance for telemetry.  ``None`` from the closed-form
    planner, which simulates nothing.

    ``coding`` is the winning :class:`~repro_torch.core.coding.CodingCandidate`
    when the Objective offered coded alternatives AND one strictly beat
    every replication split on the shared CRN draws (overheads resolved —
    measured if the objective left them ``None``).  ``None`` means
    replication won and the rest of the plan reads as before.  When coding
    wins, ``predicted`` carries the coded samples (``n_batches`` reads N:
    every worker holds a distinct coded share, replication factor 1 on the
    storage axis the replication vocabulary can express), ``policy`` and
    ``speculation_quantile`` are ``None`` (the code IS the straggler
    strategy), and ``spectrum`` still describes the replication sweep so
    hysteresis comparisons keep working.

    ``max_wait`` / ``shed`` / ``class_report`` are the serving-sweep
    decision (only when the Objective carried ``slo_classes``): the batch
    formation timeout and admission/shedding policy the winning cell ran
    with — the engine adopts BOTH live — and the per-class
    ``(name, miss_rate)`` report of that cell (NaN miss rate for classes
    with no deadline).
    """

    spec: ClusterSpec
    objective: Objective
    replication: ReplicationPlan
    assignment: Assignment
    predicted: SpectrumPoint
    spectrum: SpectrumResult
    planner: str  # name of the Planner that produced this
    closed_form_mean: Optional[float] = None  # hetero closed-form companion
    speculation_quantile: Optional[float] = None  # chosen clone trigger
    policy: Optional[PolicyCandidate] = None  # chosen straggler policy
    confidence: Optional[float] = None  # bootstrap vote share at B*
    vote_share: Optional[tuple[tuple[int, float], ...]] = None  # per-B votes
    backend: Optional[str] = None  # device that scored it (provenance)
    coding: Optional[CodingCandidate] = None  # adopted coded scheme
    max_wait: Optional[float] = None  # serving: batch-formation timeout
    shed: Optional[ShedPolicy] = None  # serving: adopted admission policy
    class_report: Optional[tuple[tuple[str, float], ...]] = None  # miss rates

    @property
    def n_workers(self) -> int:
        return self.replication.n_data

    @property
    def n_batches(self) -> int:
        return self.replication.n_batches

    @property
    def score(self) -> float:
        """Predicted value of the objective metric at the chosen B."""
        return metric_value(self.predicted, self.objective.metric)

    def predicted_at(self, n_batches: int) -> Optional[float]:
        """Objective-metric prediction at another B (None if not swept)."""
        try:
            point = self.spectrum.at(n_batches)
        except KeyError:
            return None
        return metric_value(point, self.objective.metric)

    def improvement_over(self, n_batches: int) -> float:
        """Predicted fractional win of this plan vs staying at ``n_batches``."""
        cur = self.predicted_at(n_batches)
        if cur is None:
            return math.inf
        return 1.0 - self.score / max(cur, 1e-30)


class Planner(abc.ABC):
    """Strategy interface: ``plan(spec, objective) -> Plan``.

    Subclasses implement :meth:`sweep_spectrum`; selection (argmin of the
    objective metric over feasible B) and placement are shared here.

    >>> from repro_torch.core.planner import ClusterSpec, Objective, ShiftedExponential
    >>> spec = ClusterSpec(n_workers=16, dist=ShiftedExponential(0.5, 2.0))
    >>> plan = AnalyticPlanner().plan(spec, Objective(metric="mean"))
    >>> plan.n_batches in spec.feasible_batches()
    True
    """

    name = "planner"
    # capability flag: does this planner feed per-worker rates into its
    # predictions?  Callers assembling specs (e.g. the tuner) use it to
    # decide whether collecting rate estimates is worthwhile.
    consumes_rates = False
    # capability flag: can this planner score load-aware objectives
    # (sojourn under an arrival process)?  Re-plan triggers use it to decide
    # whether observed-load telemetry should flow into the Objective.
    consumes_load = False
    # capability flag: does this planner want the RAW observation window as
    # an Empirical distribution (rather than a parametric fit)?  The tuner
    # builds the spec's dist accordingly.
    consumes_empirical = False
    # capability flag: can this planner score multi-tenant serving
    # objectives (slo_classes — per-request sweep with WFQ batch formation,
    # max_wait and shed axes)?  Serving re-plan triggers check it before
    # attaching tenant classes to the Objective.
    consumes_classes = False

    @abc.abstractmethod
    def sweep_spectrum(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        """The objective metric of every feasible B."""

    def assignment_for(self, spec: ClusterSpec, n_batches: int) -> Assignment:
        """Placement for the chosen B: rate-aware on skewed fleets, the
        runtime's replica-major balanced layout otherwise."""
        if spec.heterogeneous:
            return rate_aware_assignment(spec.n_workers, n_batches, spec.rates)
        return replica_major_nonoverlapping(spec.n_workers, n_batches)

    def _closed_form_mean(
        self, spec: ClusterSpec, assignment: Assignment
    ) -> Optional[float]:
        """Exact E[T] of the emitted placement, when tractable."""
        if spec.rates is None:
            return None
        if assignment.n_batches > _CLOSED_FORM_MAX_BATCHES:
            return None
        if not isinstance(spec.dist, (Exponential, ShiftedExponential)):
            return None
        return expected_completion_rates(
            spec.dist, spec.n_workers, assignment.worker_batch, spec.rates
        )

    def _speculation_for(self, n_batches: int) -> Optional[float]:
        """The clone trigger chosen for ``n_batches`` by the last sweep
        (None unless a speculative sweep ran and speculation won there)."""
        return None

    def _policy_for(self, n_batches: int) -> Optional[PolicyCandidate]:
        """The straggler policy chosen for ``n_batches`` by the last sweep
        (None unless the objective carried a policy portfolio)."""
        return None

    def _decision_fields(self, n_batches: int) -> dict:
        """Plan fields carrying the per-B sweep decisions: the winning
        policy candidate and — when a clone candidate won, or the legacy
        speculation sweep ran — the clone trigger mirror."""
        pol = self._policy_for(n_batches)
        if pol is not None:
            spec_q = pol.quantile if pol.kind == "clone" else None
        else:
            spec_q = self._speculation_for(n_batches)
        return {"policy": pol, "speculation_quantile": spec_q}

    def _plan_backend(self) -> Optional[str]:
        """Device of the last sweep (Plan provenance; None for planners
        that simulate nothing)."""
        return None

    def _coded_points(
        self, spec: ClusterSpec, objective: Objective
    ) -> list[tuple[CodingCandidate, SpectrumPoint]]:
        """Score the objective's coded candidates on the shared CRN draws.

        Returns ``(candidate, point)`` pairs (overheads resolved) for the
        selection race in :meth:`_select_coding`.  The base implementation
        rejects coded objectives — a coded cell with MEASURED overheads has
        no closed form, so only the simulated planners override this."""
        if not objective.coding:
            return []
        raise ValueError(
            f"{type(self).__name__} cannot score coded candidates (k-of-n "
            "completion with measured encode/decode overhead has no closed "
            "form); use SimulatedPlanner / HeterogeneousPlanner / "
            "EmpiricalPlanner"
        )

    def _select_coding(
        self,
        spec: ClusterSpec,
        objective: Objective,
        best: SpectrumPoint,
    ) -> tuple[SpectrumPoint, Optional[CodingCandidate]]:
        """Race the best coded candidate against the best replication split.

        Coding is adopted only on STRICT improvement of the objective
        metric — the shared CRN draws make the comparison pathwise, and at
        equal overhead balanced replication dominates cyclic coding
        pathwise, so ties (e.g. an (N, 1)-style code that degenerates to
        the same samples) resolve to replication and its simpler runtime.
        """
        coded = self._coded_points(spec, objective)
        if not coded:
            return best, None
        metric = objective.metric
        cand, point = min(
            coded, key=lambda cp: metric_value(cp[1], metric)
        )
        if metric_value(point, metric) < metric_value(best, metric):
            return point, cand
        return best, None

    def plan(
        self, spec: ClusterSpec, objective: Optional[Objective] = None
    ) -> Plan:
        """Sweep feasible B under ``objective``, pick the argmin, race it
        against any coded candidates, and emit the full decision (factoring
        + placement + predictions)."""
        objective = objective if objective is not None else Objective()
        spectrum = self.sweep_spectrum(spec, objective)
        best = spectrum.best(objective.metric)
        predicted, coding = self._select_coding(spec, objective, best)
        assignment = self.assignment_for(spec, predicted.n_batches)
        decisions = (
            self._decision_fields(predicted.n_batches)
            if coding is None
            else {"policy": None, "speculation_quantile": None}
        )
        return Plan(
            spec=spec,
            objective=objective,
            replication=ReplicationPlan(
                n_data=spec.n_workers, n_batches=predicted.n_batches
            ),
            assignment=assignment,
            predicted=predicted,
            spectrum=spectrum,
            planner=self.name,
            closed_form_mean=self._closed_form_mean(spec, assignment),
            backend=self._plan_backend(),
            coding=coding,
            **decisions,
        )


class AnalyticPlanner(Planner):
    """Closed-form sweep (Thms 2-4): homogeneous Exp/SExp fleets only.

    Microsecond re-plans, but no heterogeneous rates and no queueing:
    load-aware objectives (and therefore speculation) are rejected.

    >>> spec = ClusterSpec(n_workers=16, dist=Exponential(mu=2.0))
    >>> AnalyticPlanner().plan(spec, Objective(metric="mean")).n_batches
    1
    """

    name = "analytic"

    def sweep_spectrum(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        if spec.heterogeneous:
            raise ValueError(
                "AnalyticPlanner covers homogeneous fleets only (closed "
                "forms); use HeterogeneousPlanner for skewed rates"
            )
        if objective.load_aware:
            raise ValueError(
                "load-aware objectives (arrival_rate/utilization) have no "
                "closed form; use SimulatedPlanner / HeterogeneousPlanner"
            )
        if not isinstance(spec.dist, (Exponential, ShiftedExponential)):
            raise ValueError(
                f"AnalyticPlanner has closed forms for Exp/SExp only, got "
                f"{type(spec.dist).__name__}; use SimulatedPlanner (any "
                "engine-supported dist) or EmpiricalPlanner (bootstrap over "
                "an Empirical dist)"
            )
        return sweep(spec.dist, spec.n_workers, spec.feasible_batches())


@dataclasses.dataclass
class SimulatedPlanner(Planner):
    """Monte-Carlo sweep on the batched CRN engine (homogeneous view), on a
    torch device.

    One sweep call evaluates every feasible B from a shared unit-exponential
    draw matrix, so the argmin across B is far less noisy than independent
    simulations.  ``device=None`` means ``"cuda"`` and raises
    ``RuntimeError`` when no card is visible; ``device="cpu"`` runs the
    kernels' plain twins on the host.  Per-worker ``rates`` on the spec are
    NOT fed into the prediction; placement still honours them via the
    shared ``assignment_for``.

    >>> spec = ClusterSpec(n_workers=16, dist=ShiftedExponential(0.5, 2.0))
    >>> plan = SimulatedPlanner(n_trials=2_000, seed=0, device="cpu").plan(
    ...     spec, Objective(metric="p99", utilization=0.7))
    >>> plan.n_batches in spec.feasible_batches()
    True
    """

    n_trials: int = 20_000
    seed: int = 0
    device: Optional[str] = None

    name = "simulated"
    consumes_load = True
    consumes_classes = True

    def _sweep_rates(self, spec: ClusterSpec) -> Optional[np.ndarray]:
        return None

    def _speculation_for(self, n_batches: int) -> Optional[float]:
        return getattr(self, "_spec_q_by_b", {}).get(n_batches)

    def _policy_for(self, n_batches: int) -> Optional[PolicyCandidate]:
        return getattr(self, "_policy_by_b", {}).get(n_batches)

    def _plan_backend(self) -> Optional[str]:
        return getattr(self, "_last_backend", None)

    def _resolve_device(self):
        """Resolve (and record for Plan provenance) the sweep device."""
        dev = resolve_device(self.device)
        self._last_backend = device_name(dev)
        return dev

    def _resolved_coding(
        self, objective: Objective, n_workers: int, dev
    ) -> tuple[CodingCandidate, ...]:
        """Candidates with overheads resolved: any left ``None`` by the
        objective are MEASURED now (wall-clock encode/decode through the
        ``combine`` kernel on the sweep's device), so the race never scores
        coding's fixed costs as free."""
        from ..kernels.coded import measure_coding_overhead

        out = []
        for c in objective.coding:
            if not c.resolved:
                enc, dec = measure_coding_overhead(c, n_workers, device=dev)
                c = dataclasses.replace(
                    c,
                    encode_overhead=(
                        enc if c.encode_overhead is None else c.encode_overhead
                    ),
                    decode_overhead=(
                        dec if c.decode_overhead is None else c.decode_overhead
                    ),
                )
            out.append(c)
        return tuple(out)

    def _coded_sweep(self, spec: ClusterSpec, objective: Objective, dists):
        """Run the coded CRN sweep (batch or sojourn mode) for ``dists``."""
        from .simulator import sweep_coded, sweep_sojourn_coded

        dev = self._resolve_device()
        cands = self._resolved_coding(objective, spec.n_workers, dev)
        rates = self._sweep_rates(spec)
        if objective.load_aware:
            return sweep_sojourn_coded(
                dists,
                spec.n_workers,
                cands,
                arrival_rate=objective.offered_rate(spec),
                n_jobs=self.n_trials,
                seed=self.seed,
                rates=rates,
                job_load=objective.job_load,
                arrivals=objective.arrivals,
                device=dev,
            )
        return sweep_coded(
            dists,
            spec.n_workers,
            cands,
            n_trials=self.n_trials,
            seed=self.seed,
            rates=rates,
            device=dev,
        )

    def _coded_points(
        self, spec: ClusterSpec, objective: Objective
    ) -> list[tuple[CodingCandidate, SpectrumPoint]]:
        if not objective.coding:
            return []
        res = self._coded_sweep(spec, objective, spec.dist)
        return [
            (
                res.candidates[ci],
                point_from_samples(
                    spec.n_workers, 1, res.samples[0, ci]
                ),
            )
            for ci in range(len(res.candidates))
        ]

    def _sweep_sojourn(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        """Queueing-aware mode: score every candidate B by simulated sojourn
        (queue wait + service) at the objective's offered load, from ONE
        shared CRN draw matrix + arrival sequence.

        With ``objective.speculation_quantiles`` the candidates become
        (B, clone-trigger) pairs; with ``objective.policies`` (B, policy)
        pairs scored in one :func:`~repro_torch.core.simulator.
        sweep_sojourn_policies` call behind a stability gate that charges
        each policy's redundant work.  Each B keeps its best candidate,
        recorded for :attr:`Plan.speculation_quantile` / :attr:`Plan.policy`.
        """
        from .simulator import (
            sweep_sojourn,
            sweep_sojourn_policies,
            sweep_sojourn_speculative,
        )

        dev = self._resolve_device()
        if objective.policies:
            res = sweep_sojourn_policies(
                spec.dist,
                spec.n_workers,
                arrival_rate=objective.offered_rate(spec),
                policies=objective.policies,
                n_jobs=self.n_trials,
                seed=self.seed,
                feasible_b=spec.feasible_batches(),
                rates=self._sweep_rates(spec),
                job_load=objective.job_load,
                arrivals=objective.arrivals,
                device=dev,
            )
            pts = []
            self._policy_by_b = {}
            # stability gate: charge each candidate's redundant work before
            # it may win (finite-window samples of an overloaded cell lie)
            stable = [
                objective.charged_utilization(spec, p) < 1.0
                for p in res.policies
            ]
            for i, b in enumerate(res.splits):
                point, best_p = _best_speculative_point(
                    b,
                    spec.n_workers // b,
                    [res.samples[0, i, pi] for pi in range(len(res.policies))],
                    res.policies,
                    objective.metric,
                    feasible=stable,
                )
                self._policy_by_b[b] = best_p
                pts.append(point)
            return result_from_points(pts)
        if objective.speculation_quantiles:
            quantiles = (None, *objective.speculation_quantiles)
            res = sweep_sojourn_speculative(
                spec.dist,
                spec.n_workers,
                arrival_rate=objective.offered_rate(spec),
                quantiles=quantiles,
                n_jobs=self.n_trials,
                seed=self.seed,
                feasible_b=spec.feasible_batches(),
                rates=self._sweep_rates(spec),
                job_load=objective.job_load,
                arrivals=objective.arrivals,
                device=dev,
            )
            pts = []
            self._spec_q_by_b = {}
            for i, b in enumerate(res.splits):
                point, best_q = _best_speculative_point(
                    b,
                    spec.n_workers // b,
                    [res.samples[0, i, qi] for qi in range(len(quantiles))],
                    quantiles,
                    objective.metric,
                )
                self._spec_q_by_b[b] = best_q
                pts.append(point)
            return result_from_points(pts)
        self._spec_q_by_b = {}
        res = sweep_sojourn(
            spec.dist,
            spec.n_workers,
            arrival_rate=objective.offered_rate(spec),
            n_jobs=self.n_trials,
            seed=self.seed,
            feasible_b=spec.feasible_batches(),
            rates=self._sweep_rates(spec),
            job_load=objective.job_load,
            arrivals=objective.arrivals,
            device=dev,
        )
        return result_from_points(
            point_from_samples(b, spec.n_workers // b, res.samples[0, i])
            for i, b in enumerate(res.splits)
        )

    def sweep_spectrum(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        self._spec_q_by_b = {}
        self._policy_by_b = {}
        if objective.load_aware:
            return self._sweep_sojourn(spec, objective)
        return sweep_simulated(
            spec.dist,
            spec.n_workers,
            feasible_b=spec.feasible_batches(),
            n_trials=self.n_trials,
            seed=self.seed,
            rates=self._sweep_rates(spec),
            device=self._resolve_device(),
        )

    def plan(
        self, spec: ClusterSpec, objective: Optional[Objective] = None
    ) -> Plan:
        objective = objective if objective is not None else Objective()
        if objective.slo_classes:
            return self._plan_serving(spec, objective)
        return super().plan(spec, objective)

    def _plan_serving(self, spec: ClusterSpec, objective: Objective) -> Plan:
        """Multi-tenant serving sweep: every (B, policy, max_wait, shed)
        cell scored per-request on one shared-CRN draw matrix
        (:func:`~repro_torch.core.simulator.sweep_sojourn_serving`).

        Winner selection is FEASIBILITY-FIRST: a cell is feasible when its
        charged utilization stays under 1 (stability gate,
        :meth:`Objective.charged_utilization`) AND every class's
        ``miss_target`` holds (shed requests count as misses).  Among
        feasible cells — or all cells when none is feasible — the
        class-weighted objective metric over SERVED requests decides; ties
        resolve to the earliest candidate on each axis, so the 'none'
        baselines win when interventions buy nothing.  The per-B spectrum
        is built from each B's best cell (served post-warmup latencies), so
        hysteresis comparisons read the latency the engine would deliver.
        The ranking is float64 numpy on the host, timed as the
        ``"scoring"`` stage of :data:`~repro_torch.core.simulator.
        STAGE_SECONDS`.
        """
        from .simulator import _stage, sweep_sojourn_serving

        if spec.heterogeneous:
            raise ValueError(
                "multi-tenant serving objectives (slo_classes) do not "
                "support rate-skewed fleets yet — the serving sweep scores "
                "homogeneous replica sets; drop spec.rates or plan without "
                "slo_classes"
            )
        res = sweep_sojourn_serving(
            spec.dist,
            spec.n_workers,
            request_rate=objective.request_rate(spec),
            batch_size=objective.batch_size,
            slo_classes=objective.slo_classes,
            policies=objective.policies or (PolicyCandidate(),),
            max_waits=objective.max_waits or (math.inf,),
            sheds=objective.sheds or (ShedPolicy(),),
            n_requests=self.n_trials,
            seed=self.seed,
            feasible_b=spec.feasible_batches(),
            job_load=objective.job_load,
            arrivals=objective.arrivals,
            device=self._resolve_device(),
        )
        with _stage("scoring"):
            stable = [
                objective.charged_utilization(spec, p) < 1.0
                for p in res.policies
            ]
            n_p, n_w, n_h = (len(res.policies), len(res.max_waits),
                             len(res.sheds))
            best_by_b: list[tuple] = []
            for si in range(len(res.splits)):
                best = None
                for pi in range(n_p):
                    for wi in range(n_w):
                        for hi in range(n_h):
                            feas = stable[pi] and res.feasible(
                                0, si, pi, wi, hi)
                            score = res.weighted_metric(
                                0, si, pi, wi, hi, objective.metric
                            )
                            key = (not feas, score, pi, wi, hi)
                            if best is None or key < best:
                                best = key
                best_by_b.append(best)
            pts = []
            for si, b in enumerate(res.splits):
                _, _, pi, wi, hi = best_by_b[si]
                lat = res.request_latency(0, si, pi, wi, hi)[res.warmup:]
                served = lat[~np.isnan(lat)]
                if served.size == 0:
                    served = np.asarray([math.inf])
                pts.append(point_from_samples(b, spec.n_workers // b, served))
            spectrum = result_from_points(pts)
            win = min(
                range(len(res.splits)),
                key=lambda si: (best_by_b[si][0], best_by_b[si][1], si),
            )
            _, _, pi, wi, hi = best_by_b[win]
            miss = res.class_miss_rates(0, win, pi, wi, hi)
        b_star = res.splits[win]
        pol = res.policies[pi]
        return Plan(
            spec=spec,
            objective=objective,
            replication=ReplicationPlan(
                n_data=spec.n_workers, n_batches=b_star
            ),
            assignment=self.assignment_for(spec, b_star),
            predicted=spectrum.at(b_star),
            spectrum=spectrum,
            planner=self.name,
            speculation_quantile=(
                pol.quantile if pol.kind == "clone" else None
            ),
            policy=pol,
            backend=self._plan_backend(),
            max_wait=float(res.max_waits[wi]),
            shed=res.sheds[hi],
            class_report=tuple(
                (c.name, float(m)) for c, m in zip(res.classes, miss)
            ),
        )


@dataclasses.dataclass
class HeterogeneousPlanner(SimulatedPlanner):
    """Rate-aware planning for skewed fleets, on a torch device.

    Every candidate B is scored under the PLACEMENT THE PLAN EMITS:
    ``rate_aware_assignment`` (balance aggregate batch rates, not replica
    counts) simulated with the per-worker ``rates``.  Scoring the
    contiguous layout instead would pile clustered slow hosts into one
    batch and mis-rank mid-size B.  Every candidate B is simulated from
    one seed, so all share the same draw matrix (common random numbers).
    ``Plan.closed_form_mean`` carries ``expected_completion_rates`` of the
    emitted placement when B is small enough for inclusion-exclusion.

    Three branches on a skewed spec: a load-aware objective with a policy
    portfolio runs one :func:`~repro_torch.core.simulator.
    simulate_sojourn_policies` a feasible B (one ``sojourn_cells`` launch
    each); with ``speculation_quantiles``, one :func:`~repro_torch.core.
    simulator.simulate_sojourn_quantiles` a B (the same kernel); otherwise
    the coverage rule, :func:`~repro_torch.core.simulator.
    simulate_coverage`, in float64.  A homogeneous spec (no rates, or all
    equal) takes :class:`SimulatedPlanner`'s batched sweeps, bit for bit.

    >>> skewed = ClusterSpec(n_workers=8, dist=Exponential(mu=2.0),
    ...                      rates=(0.2, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0))
    >>> plan = HeterogeneousPlanner(n_trials=2_000, seed=0,
    ...                             device="cpu").plan(skewed)
    >>> plan.assignment.n_workers
    8
    """

    name = "heterogeneous"
    consumes_rates = True

    def _sweep_rates(self, spec: ClusterSpec) -> Optional[np.ndarray]:
        return np.asarray(spec.rates) if spec.rates is not None else None

    def sweep_spectrum(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        self._spec_q_by_b = {}
        self._policy_by_b = {}
        if not spec.heterogeneous:
            return super().sweep_spectrum(spec, objective)
        from .simulator import (
            simulate_coverage,
            simulate_sojourn_policies,
            simulate_sojourn_quantiles,
        )

        dev = self._resolve_device()
        pts = []
        if objective.load_aware:
            # one draw set per B (arrivals, primary and alternate matrix),
            # shared by every candidate of that B; the seed makes them
            # common across B as well
            rate = objective.offered_rate(spec)
            if objective.policies:
                stable = [
                    objective.charged_utilization(spec, p) < 1.0
                    for p in objective.policies
                ]
                labels = objective.policies
            else:
                stable = None
                labels = (None, *(objective.speculation_quantiles or ()))
            for b in spec.feasible_batches():
                kw = dict(
                    n_jobs=self.n_trials,
                    seed=self.seed,
                    rates=spec.rates,
                    job_load=objective.job_load,
                    worker_batch=rate_aware_assignment(
                        spec.n_workers, b, spec.rates
                    ).worker_batch,
                    arrivals=objective.arrivals,
                    device=dev,
                )
                if objective.policies:
                    sample_sets = simulate_sojourn_policies(
                        spec.dist, spec.n_workers, b, arrival_rate=rate,
                        policies=labels, **kw,
                    )
                else:
                    sample_sets = simulate_sojourn_quantiles(
                        spec.dist, spec.n_workers, b, arrival_rate=rate,
                        quantiles=labels, **kw,
                    )
                point, best = _best_speculative_point(
                    b, spec.n_workers // b, sample_sets, labels,
                    objective.metric, feasible=stable,
                )
                if objective.policies:
                    self._policy_by_b[b] = best
                else:
                    self._spec_q_by_b[b] = best
                pts.append(point)
            return result_from_points(pts)
        for b in spec.feasible_batches():
            sim = simulate_coverage(
                spec.dist,
                rate_aware_assignment(spec.n_workers, b, spec.rates),
                n_trials=self.n_trials,
                seed=self.seed,
                rates=spec.rates,
                device=dev,
            )
            pts.append(point_from_samples(b, spec.n_workers // b, sim.samples))
        return result_from_points(pts)


@dataclasses.dataclass
class EmpiricalPlanner(SimulatedPlanner):
    """Bootstrap planner: B* from resamples of the OBSERVED distribution.

    The spec's :class:`~repro_torch.core.order_stats.Empirical`
    distribution (censoring-aware, straight from tuner telemetry) is
    bootstrap-resampled ``n_resamples`` times on the host stream
    ``np.random.default_rng((seed, 0xB007))``; every resample is swept over
    ALL feasible B in ONE sweep call (the resamples ride the dists axis, so
    they share the CRN draw matrix, and a load-aware portfolio is one
    ``sojourn_cells`` launch of K x B x P programs), and B* is chosen by
    MAJORITY VOTE of the per-resample argmins (the pooled metric breaks
    ties).  The vote lands on the Plan as :attr:`Plan.vote_share` /
    :attr:`Plan.confidence`.  The emitted prediction and spectrum pool the
    samples of all resamples per B.

    A parametric ``spec.dist`` is accepted: a ``pool_size`` synthetic pool
    is drawn from it first.  Rate skew composes (each resample is coupled
    by rank and divided by the per-worker rate, every B scored under its
    rate-aware placement), except with the legacy
    ``speculation_quantiles`` axis, which raises.  Coded candidates race on
    the same resamples (``coded_cells``, overheads measured through
    ``combine``) and are adopted only when the pooled race AND a majority
    of resamples agree.

    >>> pool = np.random.default_rng(0).lognormal(0.0, 1.0, 2_000)
    >>> spec = ClusterSpec(n_workers=16, dist=Empirical(tuple(pool)))
    >>> plan = EmpiricalPlanner(n_trials=2_000, seed=0, n_resamples=8,
    ...                         device="cpu").plan(
    ...     spec, Objective(metric="mean"))
    >>> 0.0 < plan.confidence <= 1.0
    True
    """

    n_resamples: int = 20
    pool_size: int = 512

    name = "empirical"
    consumes_empirical = True
    consumes_rates = True
    # the serving sweep needs a mu-exposing parametric dist
    consumes_classes = False

    def _sweep_rates(self, spec: ClusterSpec) -> Optional[np.ndarray]:
        # only skewed rates are fed through: a uniform fleet keeps the
        # rate-free stream bit for bit
        return np.asarray(spec.rates) if spec.heterogeneous else None

    def _sweep_worker_batches(self, spec: ClusterSpec, splits):
        """Per-split rate-aware placements (None on a uniform fleet)."""
        if not spec.heterogeneous:
            return None
        return tuple(
            rate_aware_assignment(spec.n_workers, b, spec.rates).worker_batch
            for b in splits
        )

    def _bootstrap_dists(self, spec: ClusterSpec) -> tuple[Empirical, ...]:
        if self.n_resamples < 1:
            raise ValueError(
                f"n_resamples must be >= 1, got {self.n_resamples}"
            )
        # a stream of its own: resampling noise and simulation noise must
        # not be correlated
        rng = np.random.default_rng((self.seed, 0xB007))
        base = spec.dist
        if not isinstance(base, Empirical):
            base = Empirical(tuple(base.sample(rng, self.pool_size)))
        return tuple(base.bootstrap(rng) for _ in range(self.n_resamples))

    def _reduce_votes(
        self,
        splits: Sequence[int],
        n_workers: int,
        per_cell_samples,  # (k, s) -> 1-D samples of resample k at splits[s]
        metric: Metric,
        pooled: bool = True,
    ) -> Optional[SpectrumResult]:
        """Votes (on ``self._votes``), each resample's best replication
        score (on ``self._resample_best``, what the coded race votes
        against) and, unless ``pooled=False``, the pooled spectrum."""
        k_count = self.n_resamples
        cells = [
            [per_cell_samples(k, s) for s in range(len(splits))]
            for k in range(k_count)
        ]
        votes: dict[int, int] = {b: 0 for b in splits}
        resample_best: list[float] = []
        for k in range(k_count):
            scores = [
                metric_value(
                    point_from_samples(b, n_workers // b, cells[k][s]),
                    metric,
                )
                for s, b in enumerate(splits)
            ]
            votes[splits[int(np.argmin(scores))]] += 1
            resample_best.append(min(scores))
        self._votes = votes
        self._resample_best = resample_best
        if not pooled:
            return None
        return result_from_points(
            point_from_samples(
                b,
                n_workers // b,
                np.concatenate([cells[k][s] for k in range(k_count)]),
            )
            for s, b in enumerate(splits)
        )

    def _reduce_candidates(self, spec, objective, splits, samples, labels,
                           allowed, chosen: dict):
        """Votes and pooled spectrum of a (resample, B, candidate) sweep.

        The candidate REPORTED per B (into ``chosen``) comes from the
        pooled samples; each resample votes for the B it would run under
        the candidate it would pick; the pooled spectrum describes the
        reported candidates.  ``allowed`` lists the candidate indices that
        may win.
        """
        n = spec.n_workers
        metric = objective.metric
        best_index: dict[int, int] = {}
        for s, b in enumerate(splits):
            pooled_pts = [
                point_from_samples(b, n // b, samples[:, s, ci, :].ravel())
                for ci in range(len(labels))
            ]
            best_index[b] = min(
                allowed, key=lambda ci: metric_value(pooled_pts[ci], metric)
            )
            chosen[b] = labels[best_index[b]]

        def cell(k: int, s: int):
            pts = [
                point_from_samples(splits[s], n // splits[s],
                                   samples[k, s, ci])
                for ci in range(len(labels))
            ]
            ci = min(allowed, key=lambda i: metric_value(pts[i], metric))
            return samples[k, s, ci]

        self._reduce_votes(splits, n, cell, metric, pooled=False)
        return result_from_points(
            point_from_samples(
                b, n // b, samples[:, s, best_index[b], :].ravel()
            )
            for s, b in enumerate(splits)
        )

    def sweep_spectrum(
        self, spec: ClusterSpec, objective: Objective
    ) -> SpectrumResult:
        from .simulator import (
            sweep_simulate,
            sweep_sojourn,
            sweep_sojourn_policies,
            sweep_sojourn_speculative,
        )

        self._spec_q_by_b = {}
        self._policy_by_b = {}
        if spec.has_skewed_rates and objective.speculation_quantiles:
            raise ValueError(
                "EmpiricalPlanner cannot combine a rate-skewed fleet with "
                "the legacy speculation_quantiles axis — express clone "
                "triggers as PolicyCandidate('clone', q) entries in "
                "Objective.policies (the policy axis threads the rate-aware "
                "placement through the bootstrap sweep), or use "
                "HeterogeneousPlanner (make_planner('simulate', "
                "heterogeneous=True))."
            )
        dists = self._bootstrap_dists(spec)
        # the coded race must reuse THESE resamples
        self._last_dists = dists
        splits = spec.feasible_batches()
        rates = self._sweep_rates(spec)
        worker_batches = self._sweep_worker_batches(spec, splits)
        dev = self._resolve_device()
        common = dict(n_jobs=self.n_trials, seed=self.seed,
                      feasible_b=splits, job_load=objective.job_load,
                      arrivals=objective.arrivals, device=dev)
        if objective.load_aware and objective.policies:
            res = sweep_sojourn_policies(
                dists, spec.n_workers,
                arrival_rate=objective.offered_rate(spec),
                policies=objective.policies, rates=rates,
                worker_batches=worker_batches, **common,
            )
            # the stability gate (charged utilization < 1) masks candidates
            # whose redundant work overloads the fleet, unless it masks all
            stable = [
                objective.charged_utilization(spec, p) < 1.0
                for p in res.policies
            ]
            allowed = ([i for i, ok in enumerate(stable) if ok]
                       if any(stable) else list(range(len(res.policies))))
            return self._reduce_candidates(
                spec, objective, splits, res.samples, res.policies, allowed,
                self._policy_by_b,
            )
        if objective.load_aware and objective.speculation_quantiles:
            quantiles = (None, *objective.speculation_quantiles)
            res = sweep_sojourn_speculative(
                dists, spec.n_workers,
                arrival_rate=objective.offered_rate(spec),
                quantiles=quantiles, **common,
            )
            return self._reduce_candidates(
                spec, objective, splits, res.samples, quantiles,
                list(range(len(quantiles))), self._spec_q_by_b,
            )
        if objective.load_aware:
            res = sweep_sojourn(
                dists, spec.n_workers,
                arrival_rate=objective.offered_rate(spec), rates=rates,
                worker_batches=worker_batches, **common,
            )
        else:
            res = sweep_simulate(
                dists,
                spec.n_workers,
                n_trials=self.n_trials,
                seed=self.seed,
                feasible_b=splits,
                rates=rates,
                device=dev,
                worker_batches=worker_batches,
            )
        return self._reduce_votes(
            splits,
            spec.n_workers,
            lambda k, s: res.samples[k, s],
            objective.metric,
        )

    def _coded_points(
        self, spec: ClusterSpec, objective: Objective
    ) -> list[tuple[CodingCandidate, SpectrumPoint]]:
        if not objective.coding:
            return []
        dists = getattr(self, "_last_dists", None)
        if dists is None:
            self._last_dists = dists = self._bootstrap_dists(spec)
        res = self._coded_sweep(spec, objective, dists)
        # the coded race's own vote: the fraction of resamples whose best
        # coded candidate beats the replication score that SAME resample
        # voted for (Plan.confidence when coding wins)
        resample_best = getattr(self, "_resample_best", None)
        if resample_best is not None and len(resample_best) == len(dists):
            metric = objective.metric
            wins = 0
            for k in range(len(dists)):
                coded_best = min(
                    metric_value(
                        point_from_samples(
                            spec.n_workers, 1, res.samples[k, ci]
                        ),
                        metric,
                    )
                    for ci in range(len(res.candidates))
                )
                wins += coded_best < resample_best[k]
            self._coding_votes = wins / len(dists)
        # pooled points, matching the pooled replication spectrum
        return [
            (
                res.candidates[ci],
                point_from_samples(
                    spec.n_workers, 1, res.samples[:, ci, :].ravel()
                ),
            )
            for ci in range(len(res.candidates))
        ]

    def _select_coding(
        self,
        spec: ClusterSpec,
        objective: Objective,
        best: SpectrumPoint,
    ) -> tuple[SpectrumPoint, Optional[CodingCandidate]]:
        """Adopt coding only when the pooled race AND a majority of the
        resamples agree."""
        self._coding_votes = None
        predicted, coding = super()._select_coding(spec, objective, best)
        if coding is not None and (
            self._coding_votes is not None and self._coding_votes <= 0.5
        ):
            return best, None
        return predicted, coding

    def plan(
        self, spec: ClusterSpec, objective: Optional[Objective] = None
    ) -> Plan:
        """Sweep the resamples, pick B* by majority vote (pooled metric
        breaks ties), race it against any coded candidates, and report the
        vote on the Plan."""
        objective = objective if objective is not None else Objective()
        if objective.slo_classes:
            raise ValueError(
                "EmpiricalPlanner cannot score multi-tenant serving "
                "objectives (slo_classes): the serving sweep's admission "
                "model needs a parametric service distribution; use "
                "SimulatedPlanner (make_planner('simulate'))"
            )
        spectrum = self.sweep_spectrum(spec, objective)
        votes = self._votes
        total = sum(votes.values())
        best_b = max(
            (p.n_batches for p in spectrum.points),
            key=lambda b: (
                votes.get(b, 0),
                -metric_value(spectrum.at(b), objective.metric),
            ),
        )
        best = spectrum.at(best_b)
        predicted, coding = self._select_coding(spec, objective, best)
        assignment = self.assignment_for(spec, predicted.n_batches)
        if coding is None:
            decisions = self._decision_fields(best_b)
            confidence = votes.get(best_b, 0) / total
        else:
            decisions = {"policy": None, "speculation_quantile": None}
            confidence = self._coding_votes
        return Plan(
            spec=spec,
            objective=objective,
            replication=ReplicationPlan(
                n_data=spec.n_workers, n_batches=predicted.n_batches
            ),
            assignment=assignment,
            predicted=predicted,
            spectrum=spectrum,
            planner=self.name,
            closed_form_mean=self._closed_form_mean(spec, assignment),
            backend=self._plan_backend(),
            coding=coding,
            **decisions,
            confidence=confidence,
            vote_share=tuple(
                (p.n_batches, votes.get(p.n_batches, 0) / total)
                for p in spectrum.points
            ),
        )


def make_planner(
    mode: str = "analytic",
    heterogeneous: bool = False,
    n_trials: int = 20_000,
    seed: int = 0,
    device: Optional[str] = None,
    n_resamples: int = 20,
) -> Planner:
    """Map the tuner knobs (mode / heterogeneous / sim_*) to a Planner.

    >>> make_planner(mode="simulate", heterogeneous=True).name
    'heterogeneous'
    >>> make_planner(mode="empirical").name
    'empirical'
    """
    if mode == "analytic":
        if heterogeneous:
            raise ValueError(
                "heterogeneous (rate-aware) planning needs mode='simulate' — "
                "the analytic closed forms cover homogeneous fleets only"
            )
        return AnalyticPlanner()
    if mode == "simulate":
        cls = HeterogeneousPlanner if heterogeneous else SimulatedPlanner
        return cls(n_trials=n_trials, seed=seed, device=device)
    if mode == "empirical":
        # heterogeneous is accepted: EmpiricalPlanner consumes rate skew
        # directly, so the knob only matters for the other modes
        return EmpiricalPlanner(
            n_trials=n_trials, seed=seed, device=device,
            n_resamples=n_resamples,
        )
    raise ValueError(
        f"unknown planner mode {mode!r} (use 'analytic'|'simulate'|'empirical')"
    )
