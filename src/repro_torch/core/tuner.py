"""Online diversity–parallelism tuner: observe -> fit -> ``Planner.plan``.

The port of ``repro.core.tuner``.  The tuner ingests per-step, per-worker
service times (censored when the step completed before slow workers
finished), keeps a sliding window, fits the service distribution
(:mod:`repro_torch.core.estimator`) and estimates per-worker rates, all on
the host.  The B decision is NOT made here: the tuner assembles a
:class:`~repro_torch.core.planner.ClusterSpec` from its window and
delegates to a :class:`~repro_torch.core.planner.Planner` — analytic,
simulated, heterogeneous or empirical (see
:func:`~repro_torch.core.planner.make_planner`), whose sweeps run on
``TunerConfig.device`` (None means CUDA).  A re-plan is emitted only when
the predicted improvement clears the Objective's hysteresis threshold and
a cooldown has elapsed — re-factoring the mesh is not free, so the fleet
moves only for real wins.  With ``TunerConfig.replan_time_budget`` set,
the cooldown pacing is waived whenever the measured re-plan time
(:attr:`StragglerTuner.last_replan_seconds`) comes in under budget —
hysteresis alone then decides when to move.

Serving feeds three extra telemetry streams: :meth:`StragglerTuner
.observe_load` (measured batch-job arrival rate), :meth:`StragglerTuner
.observe_sojourn` (per-request queue wait + service), and
:meth:`StragglerTuner.observe_deadline_misses` (SLO outcomes of requests
carrying deadlines).  With a load-capable planner the re-plan Objective then
carries the observed arrival rate — candidate B is scored by simulated
sojourn quantiles — and hysteresis measures the predicted win against the
sojourn requests ACTUALLY experienced at the current B.  A breached
``TunerConfig.miss_rate_target`` (or a tenant class's own target) waives
the hysteresis threshold: when the fleet is missing its SLO, any
predicted improvement justifies the move.

**Goodness-of-fit gate.**  With ``TunerConfig.gof_alpha`` set, every
re-plan attempt first checks the fitted distribution against the
observation window (censoring-aware KS, :func:`~repro_torch.core.estimator
.goodness_of_fit`); a REJECTED fit reroutes that re-plan through the
empirical path — the window becomes an :class:`~repro_torch.core
.order_stats.Empirical` distribution (Kaplan-Meier, so censored replicas
still count) and an :class:`~repro_torch.core.planner.EmpiricalPlanner`
plans over bootstrap resamples of it.  ``TunerConfig(mode='empirical')``
makes that path the primary planner instead of the fallback.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import deque
from typing import Literal, Optional

import numpy as np

from .estimator import FitResult, GofResult, fit_best, goodness_of_fit
from .order_stats import Empirical
from .planner import (
    ClusterSpec,
    Objective,
    Plan,
    Planner,
    make_planner,
)
from .replication import ReplicationPlan
from .spectrum import Metric

__all__ = ["TunerConfig", "RescalePlan", "StragglerTuner"]


@dataclasses.dataclass(frozen=True)
class TunerConfig:
    window_steps: int = 50  # sliding window of step observations
    min_samples: int = 64  # don't fit with fewer points
    improvement_threshold: float = 0.10  # >=10% predicted win to move
    cooldown_steps: int = 20  # steps between re-plans
    metric: Metric = "mean"  # the ONE shared Metric literal (incl. p999)
    # "analytic": closed-form sweep (homogeneous Exp/SExp only).
    # "simulate": one batched sweep_simulate call, optionally with the
    # per-worker rate estimates from the observation window (heterogeneous).
    # "empirical": bootstrap-resample the observation window itself
    # (EmpiricalPlanner) — no parametric family assumed at all.
    mode: Literal["analytic", "simulate", "empirical"] = "analytic"
    heterogeneous: bool = False  # feed worker_rates() into the simulated sweep
    sim_trials: int = 4_000
    # torch device of the simulated/empirical planners' sweeps: None means
    # "cuda" (which must be present), "cpu" runs the kernels' plain twins
    device: Optional[str] = None
    sim_seed: int = 0
    # wall-clock budget (seconds) for one full re-plan.  The cooldown
    # exists to amortize EXPENSIVE sweeps; when a full re-plan is
    # measured-cheap, rate-limiting it only delays reactions to drift.
    # When set, any attempt whose measured plan() time came in at or under
    # this budget stops counting against the cooldown pacing — re-plans
    # are then gated by hysteresis alone.  None keeps the fixed cooldown.
    replan_time_budget: Optional[float] = None
    # SLO trigger: when the observed deadline-miss rate exceeds this target,
    # the hysteresis threshold is waived for the next re-plan (None = off)
    miss_rate_target: Optional[float] = None
    # sliding-window size, in REQUESTS, for deadline-miss telemetry.
    # observe_deadline_misses feeds ONE entry per resolved request (served
    # or dropped), so the window that matches window_steps batches of
    # telemetry is window_steps x the serving batch size — the engine sets
    # exactly that.  None = window_steps entries (legacy).
    miss_window: Optional[int] = None
    # goodness-of-fit gate: when set, each re-plan attempt KS-tests the
    # parametric fit against the observation window (censoring-aware) at
    # this significance level; a rejected fit reroutes THAT re-plan through
    # the empirical path (EmpiricalPlanner over the window's Kaplan-Meier
    # ECDF).  None = gate off (always trust the parametric fit).
    gof_alpha: Optional[float] = None
    # bootstrap resamples for the empirical path (primary or gate fallback)
    bootstrap_resamples: int = 20

    def objective(self) -> Objective:
        """The planner Objective this config describes."""
        return Objective(
            metric=self.metric,
            improvement_threshold=self.improvement_threshold,
            cooldown_steps=self.cooldown_steps,
        )

    def planner(self) -> Planner:
        """The Planner this config describes (legacy-knob mapping).

        ``heterogeneous=True`` with the default ``mode='analytic'`` was
        legal-but-inert before the planner API; the legacy mapping keeps
        that behavior (warn + ignore the flag) where the strict
        :func:`make_planner` would raise.
        """
        heterogeneous = self.heterogeneous
        if self.mode == "analytic" and heterogeneous:
            warnings.warn(
                "TunerConfig(heterogeneous=True) has no effect with "
                "mode='analytic'; use mode='simulate' for rate-aware "
                "re-plans",
                DeprecationWarning,
                stacklevel=2,
            )
            heterogeneous = False
        return make_planner(
            mode=self.mode,
            heterogeneous=heterogeneous,
            n_trials=self.sim_trials,
            seed=self.sim_seed,
            device=self.device,
            n_resamples=self.bootstrap_resamples,
        )


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_batches: int
    new_batches: int
    predicted_old: float
    predicted_new: float
    fit: FitResult
    step: int
    plan: Optional[Plan] = None  # the full planner decision (assignment etc.)

    @property
    def predicted_improvement(self) -> float:
        if self.predicted_old <= 0:
            return 0.0
        return 1.0 - self.predicted_new / self.predicted_old


class StragglerTuner:
    """Observe-window + re-plan trigger around a :class:`Planner`."""

    # verdict of the goodness-of-fit gate at the last re-plan attempt (None
    # while the gate is off or before the first attempt); class-level default
    # so the attribute is part of the documented API surface
    last_gof: Optional[GofResult] = None
    # measured wall-clock seconds of the last planner.plan() call (None
    # before the first attempt).  This is what TunerConfig
    # .replan_time_budget compares against to decide whether cooldown
    # pacing is still buying anything.
    last_replan_seconds: Optional[float] = None

    def __init__(
        self,
        plan: ReplicationPlan,
        config: TunerConfig | None = None,
        planner: Planner | None = None,
        batch_divisor: int | None = None,
        job_load: float = 1.0,
        speculation_quantiles: tuple[float, ...] | None = None,
        policy_candidates: tuple | None = None,
        arrival_offsets: np.ndarray | None = None,
        coding_candidates: tuple | None = None,
        slo_classes: tuple | None = None,
        serving_batch_size: int | None = None,
        max_wait_candidates: tuple[float, ...] | None = None,
        shed_candidates: tuple | None = None,
    ):
        self.plan = plan
        self.config = config or TunerConfig()
        self.planner = planner if planner is not None else self.config.planner()
        # extra feasibility constraint carried into every ClusterSpec: B must
        # divide this (e.g. the global batch size, so re-plans never pick a B
        # the data pipeline cannot shard)
        self.batch_divisor = batch_divisor
        # units of data one batch-job carries (serving: batch tokens / unit);
        # scales the load-aware objective's service model
        self.job_load = job_load
        # clone triggers the serving master is running: load-aware re-plans
        # must score candidate B WITH speculation, else a fleet that is only
        # stable because it speculates looks saturated to the planner
        self.speculation_quantiles = (
            tuple(float(q) for q in speculation_quantiles)
            if speculation_quantiles
            else None
        )
        # straggler-policy portfolio: when set, load-aware re-plans score
        # every (B, candidate) cell and land the winner on Plan.policy —
        # this is how the tuner switches policy online when the fitted /
        # empirical distribution drifts across a regime boundary.
        # Mutually exclusive with speculation_quantiles (Objective enforces).
        self.policy_candidates = (
            tuple(policy_candidates) if policy_candidates else None
        )
        if self.policy_candidates and self.speculation_quantiles:
            raise ValueError(
                "policy_candidates and speculation_quantiles are mutually "
                "exclusive: the portfolio subsumes the clone-trigger sweep "
                "(use PolicyCandidate('clone', quantile=q) candidates)"
            )
        # coded-computation portfolio: when set, every re-plan races the
        # listed CodingCandidates (cyclic / MDS / poly, measured overheads)
        # against the replication sweep on shared CRN draws and lands a
        # strict winner on Plan.coding — both batch-completion and
        # load-aware objectives, simulated planners only.
        self.coding_candidates = (
            tuple(coding_candidates) if coding_candidates else None
        )
        # multi-tenant serving: when set, load-aware re-plans run the
        # SERVING sweep (per-request admission/WFQ/shedding model) instead
        # of the job-level sojourn sweep — every (B, policy, max_wait,
        # shed) cell scored on shared CRN draws, winner landing on
        # Plan.max_wait / Plan.shed / Plan.class_report.  Requires the
        # serving batch size (Objective.request_rate needs it to convert
        # the observed JOB arrival rate back to a request rate).
        self.slo_classes = tuple(slo_classes) if slo_classes else None
        self.serving_batch_size = (
            int(serving_batch_size) if serving_batch_size is not None else None
        )
        self.max_wait_candidates = (
            tuple(float(w) for w in max_wait_candidates)
            if max_wait_candidates
            else None
        )
        self.shed_candidates = (
            tuple(shed_candidates) if shed_candidates else None
        )
        if self.slo_classes:
            if self.serving_batch_size is None:
                raise ValueError(
                    "slo_classes requires serving_batch_size (the request "
                    "rate is the observed job rate times the batch size)"
                )
            if self.speculation_quantiles:
                raise ValueError(
                    "slo_classes and speculation_quantiles are mutually "
                    "exclusive; use PolicyCandidate('clone', quantile=q) "
                    "entries in policy_candidates"
                )
            if self.coding_candidates:
                raise ValueError(
                    "slo_classes and coding_candidates are mutually "
                    "exclusive: the serving sweep scores replication "
                    "policies only"
                )
        elif (
            self.max_wait_candidates
            or self.shed_candidates
            or self.serving_batch_size is not None
        ):
            raise ValueError(
                "serving_batch_size / max_wait_candidates / shed_candidates "
                "only apply with slo_classes"
            )
        # measured job-arrival offsets (non-Poisson traffic): threaded into
        # the load-aware sweep so candidates are scored under the arrival
        # process the engine actually runs, not a Poisson stand-in
        self.arrival_offsets = (
            tuple(float(a) for a in np.asarray(arrival_offsets, float).ravel())
            if arrival_offsets is not None and np.asarray(arrival_offsets).size
            else None
        )
        self._times: deque[np.ndarray] = deque(maxlen=self.config.window_steps)
        self._censored: deque[np.ndarray] = deque(maxlen=self.config.window_steps)
        # wall-clock (tagged) telemetry: per-worker censored-MLE accumulators
        # keyed by caller-assigned worker id.  Cluster jobs observe a
        # VARIABLE number of replicas per completion (r changes with B, the
        # fleet shrinks on kills), so the fixed-shape window behind
        # worker_rates() never applies there; each id instead accumulates
        # (n_uncensored, total_time, n_observations) exactly like the
        # windowed estimator — see rates_for().
        self._tagged: deque[tuple[np.ndarray, np.ndarray, np.ndarray]] = (
            deque(maxlen=self.config.window_steps)
        )
        self._load: deque[float] = deque(maxlen=self.config.window_steps)
        self._sojourns: deque[np.ndarray] = deque(
            maxlen=self.config.window_steps
        )
        # (n_missed, n_total) per observation: windowed deadline-miss
        # telemetry, one entry per resolved request — sized in request
        # units (TunerConfig.miss_window), window_steps entries by default
        self._miss_window = (
            self.config.miss_window
            if self.config.miss_window is not None
            else self.config.window_steps
        )
        if self._miss_window < 1:
            raise ValueError(
                f"miss_window must be >= 1, got {self._miss_window}"
            )
        self._misses: deque[tuple[int, int]] = deque(
            maxlen=self._miss_window
        )
        # same telemetry split per SLO class (key = class name): the
        # per-class windows drive class-target breach detection — a fleet
        # meeting its GLOBAL miss target can still be starving one tenant
        self._class_misses: dict[str, deque[tuple[int, int]]] = {}
        self._step = 0
        self._last_replan = -(10**9)
        self._last_attempt = -(10**9)
        self.last_fit: Optional[FitResult] = None
        self.last_plan: Optional[Plan] = None
        self.last_gof = None
        self.last_replan_seconds = None
        self._gof_fallback: Optional[Planner] = None  # lazy EmpiricalPlanner

    def observe(
        self, step_times: np.ndarray, censored: np.ndarray | None = None
    ) -> None:
        """Record one step of per-worker service times.

        ``step_times`` are normalized to PER-UNIT-OF-DATA times (divide the
        measured time by the worker's batch size) so that fits are comparable
        across different B.  Infinite times (dead workers) are recorded as
        censored at the max finite time.
        """
        t = np.asarray(step_times, dtype=float).copy()
        c = (
            np.zeros(t.shape, dtype=bool)
            if censored is None
            else np.asarray(censored, dtype=bool).copy()
        )
        dead = ~np.isfinite(t)
        if dead.all():
            return  # nothing usable this step
        if dead.any():
            t[dead] = t[~dead].max()
            c |= dead
        self._times.append(t)
        self._censored.append(c)
        self._step += 1

    def observe_tagged(
        self,
        worker_ids: np.ndarray,
        times: np.ndarray,
        censored: np.ndarray | None = None,
    ) -> None:
        """Record wall-clock observations ATTRIBUTED to specific workers.

        The multi-process cluster runtime feeds per-job telemetry here: a
        completed batch contributes one (possibly censored) service time per
        replica that ran it, tagged with the worker id that produced it.
        Unlike :meth:`observe`, rows may cover any SUBSET of the fleet and
        any number of replicas — exactly what wall-clock dispatch produces
        (r changes with B, workers die, clones run on other sets).

        The observations join the same sliding window :meth:`fit` and the
        re-plan path consume (so fits, KS gates, and empirical re-plans see
        wall-clock telemetry unchanged), AND accumulate per-worker for
        :meth:`rates_for` — the kill-/cancellation-censored per-worker rate
        estimates recovery planning feeds to
        the fault manager's recovery planning.
        """
        ids = np.asarray(worker_ids, dtype=int).ravel()
        t = np.asarray(times, dtype=float).ravel()
        if ids.shape != t.shape:
            raise ValueError(
                f"worker_ids shape {ids.shape} != times shape {t.shape}"
            )
        c = (
            np.zeros(t.shape, dtype=bool)
            if censored is None
            else np.asarray(censored, dtype=bool).ravel()
        )
        if c.shape != t.shape:
            raise ValueError(
                f"censored shape {c.shape} != times shape {t.shape}"
            )
        keep = np.isfinite(t) & (t > 0)
        if not keep.any():
            return
        self._tagged.append((ids[keep], t[keep], c[keep]))
        self.observe(t[keep], censored=c[keep])

    def rates_for(self, worker_ids) -> Optional[np.ndarray]:
        """Per-worker relative rates for ``worker_ids`` from tagged telemetry.

        Same censored-exponential MLE as :meth:`worker_rates`
        (``rate ~ n_uncensored / sum(times)``, half a pseudo-observation
        for all-censored workers, normalized to mean 1) but computed from
        the :meth:`observe_tagged` accumulators, so it tolerates the
        variable-shape observations wall-clock dispatch produces.  Returns
        None until every requested worker has at least one observation —
        recovery planning falls back to a homogeneous spec rather than
        guessing rates for an unmeasured worker.
        """
        ids = [int(w) for w in worker_ids]
        if not ids or not self._tagged:
            return None
        n_unc: dict[int, float] = {w: 0.0 for w in ids}
        total: dict[int, float] = {w: 0.0 for w in ids}
        wanted = set(ids)
        for row_ids, row_t, row_c in self._tagged:
            for w, t, c in zip(row_ids, row_t, row_c):
                w = int(w)
                if w in wanted:
                    total[w] += float(t)
                    n_unc[w] += 0.0 if c else 1.0
        if any(total[w] <= 0 for w in ids):
            return None
        rates = np.array([max(n_unc[w], 0.5) / total[w] for w in ids])
        return rates / rates.mean()

    def observe_load(self, arrival_rate: float) -> None:
        """Record one observation of the batch-job arrival rate.

        The serving engine feeds its measured formation rate here; the
        windowed mean becomes the ``arrival_rate`` of the re-plan Objective
        when the planner can consume load, closing the loop on real traffic
        instead of an operator-guessed constant.
        """
        if np.isfinite(arrival_rate) and arrival_rate > 0:
            self._load.append(float(arrival_rate))

    @property
    def observed_arrival_rate(self) -> Optional[float]:
        """Windowed mean of the observed batch-job arrival rate."""
        if not self._load:
            return None
        return float(np.mean(self._load))

    def observe_sojourn(self, sojourns: np.ndarray) -> None:
        """Record per-request sojourn times (queue wait + service).

        Used as the OBSERVED baseline in load-aware hysteresis: a predicted
        win is measured against the latency requests actually experienced at
        the current B, not against the model's own prediction of it.
        """
        s = np.asarray(sojourns, dtype=float).ravel()
        s = s[np.isfinite(s)]
        if s.size:
            self._sojourns.append(s)

    def observe_deadline_misses(
        self, n_missed: int, n_total: int, slo: str = ""
    ) -> None:
        """Record SLO outcomes: of ``n_total`` deadline-carrying requests
        that resolved (served or dropped), ``n_missed`` missed.

        The windowed rate (:attr:`observed_miss_rate`) is the SLO re-plan
        trigger: past ``TunerConfig.miss_rate_target`` the next re-plan
        skips the hysteresis threshold — a fleet in breach moves for any
        predicted win, not just a large one.  ``slo`` attributes the
        observation to a tenant class; per-class windows
        (:meth:`class_miss_rates`) then drive class-target breach
        detection for multi-tenant objectives.
        """
        if n_total < 0 or not 0 <= n_missed <= max(n_total, 0):
            raise ValueError(
                f"invalid miss telemetry ({n_missed}/{n_total})"
            )
        if n_total > 0:
            self._misses.append((int(n_missed), int(n_total)))
            if slo:
                lane = self._class_misses.get(slo)
                if lane is None:
                    lane = deque(maxlen=self._miss_window)
                    self._class_misses[slo] = lane
                lane.append((int(n_missed), int(n_total)))

    @property
    def observed_miss_rate(self) -> Optional[float]:
        """Windowed deadline-miss fraction (None without miss telemetry)."""
        if not self._misses:
            return None
        missed = sum(m for m, _ in self._misses)
        total = sum(t for _, t in self._misses)
        return missed / total

    def class_miss_rates(self) -> dict[str, float]:
        """Windowed deadline-miss fraction per SLO class (observed classes
        only — a class with no resolved deadline-carrying requests in the
        window has no entry)."""
        out: dict[str, float] = {}
        for name, lane in self._class_misses.items():
            total = sum(t for _, t in lane)
            if total > 0:
                out[name] = sum(m for m, _ in lane) / total
        return out

    def _class_target_breached(self) -> bool:
        """Whether any SLO class with a miss target is over it (windowed)."""
        if not self.slo_classes:
            return False
        rates = self.class_miss_rates()
        return any(
            c.miss_target is not None
            and rates.get(c.name) is not None
            and rates[c.name] > c.miss_target
            for c in self.slo_classes
        )

    def observed_sojourn(self, metric: Metric) -> Optional[float]:
        """The objective metric evaluated on the observed sojourn window."""
        if not self._sojourns:
            return None
        s = np.concatenate(list(self._sojourns))
        if s.size < 2:
            return None
        if metric == "mean":
            return float(s.mean())
        if metric == "var":
            return float(s.var(ddof=1))
        if metric == "p99":
            return float(np.quantile(s, 0.99))
        if metric == "p999":
            return float(np.quantile(s, 0.999))
        raise ValueError(f"unknown metric {metric!r}")

    @property
    def n_samples(self) -> int:
        return int(sum(t.size for t in self._times))

    def window_observations(self) -> tuple[np.ndarray, np.ndarray]:
        """The flattened observation window: (times, censored_mask)."""
        x = np.concatenate([t.ravel() for t in self._times])
        c = np.concatenate([m.ravel() for m in self._censored])
        return x, c

    def fit(self) -> Optional[FitResult]:
        if self.n_samples < self.config.min_samples:
            return None
        x, c = self.window_observations()
        if (~c).sum() == 0:
            return None
        self.last_fit = fit_best(x, c)
        return self.last_fit

    def empirical_dist(self) -> Empirical:
        """The observation window as a censoring-aware Empirical (KM ECDF).

        The distribution the empirical re-plan path hands to
        :class:`~repro_torch.core.planner.EmpiricalPlanner` — the fleet as
        measured, no parametric family assumed.
        """
        x, c = self.window_observations()
        return Empirical.from_censored(x, c)

    def _empirical_fallback_planner(self) -> Planner:
        """The EmpiricalPlanner used when the GoF gate rejects the fit
        (built once, from the config's sim budget)."""
        if self._gof_fallback is None:
            self._gof_fallback = make_planner(
                mode="empirical",
                n_trials=self.config.sim_trials,
                seed=self.config.sim_seed,
                device=self.config.device,
                n_resamples=self.config.bootstrap_resamples,
            )
        return self._gof_fallback

    def worker_rates(self) -> Optional[np.ndarray]:
        """Per-worker relative service rates estimated from the window.

        Censored-exponential MLE per worker: ``rate_j ~ n_uncensored_j /
        sum(times_j)`` — censored observations still contribute their
        lower-bound time to the denominator, so a persistently-censored
        slow worker is estimated SLOW instead of being dropped (discarding
        censored draws would keep only a straggler's lucky fast ones and
        bias its rate high).  A worker with zero uncensored observations
        gets a half pseudo-observation to stay finite-and-slow.  Rates are
        normalized to mean 1 (the fitted mu carries the absolute scale).

        Returns None on an empty window or while the window holds mixed
        worker counts (mid-elastic-resize) — callers fall back to the
        homogeneous plan until a clean window accumulates.
        """
        if not self._times:
            return None
        if len({t.shape for t in self._times}) != 1:
            return None
        t = np.stack(list(self._times))  # (steps, N)
        c = np.stack(list(self._censored))
        n_unc = (~c).sum(axis=0).astype(float)
        total = t.sum(axis=0)
        if np.any(total <= 0):
            return None
        rates = np.maximum(n_unc, 0.5) / total
        return rates / rates.mean()

    def cluster_spec(self, fit: FitResult) -> ClusterSpec:
        """The fleet as currently observed: fitted dist + (optional) rates.

        Rates are only attached when the planner can consume them (a
        rate-incapable planner would otherwise reject the spec outright).
        """
        rates = None
        if self.planner.consumes_rates:
            rates = self.worker_rates()
            if rates is not None and len(rates) != self.plan.n_data:
                rates = None  # observed fleet != plan size: homogeneous fallback
        return ClusterSpec.from_fit(
            fit, self.plan.n_data, rates=rates,
            batch_divisor=self.batch_divisor,
        )

    def objective(self, planner: Optional[Planner] = None) -> Objective:
        """The re-plan Objective: the config's, upgraded with observed load.

        When the planner can score load-aware objectives and the engine has
        fed arrival-rate telemetry (:meth:`observe_load`), the objective
        carries the OBSERVED offered load — the planner then optimizes
        sojourn under real traffic rather than batch completion.
        ``planner`` is the planner this attempt will actually use (the GoF
        gate may have swapped in the empirical fallback); defaults to the
        primary.
        """
        planner = planner if planner is not None else self.planner
        objective = self.config.objective()
        rate = self.observed_arrival_rate
        if planner.consumes_load and rate is not None:
            objective = dataclasses.replace(
                objective,
                arrival_rate=rate,
                utilization=None,
                job_load=self.job_load,
                speculation_quantiles=self.speculation_quantiles,
                policies=self.policy_candidates,
                arrivals=self.arrival_offsets,
            )
            # multi-tenant serving: a class-capable planner re-plans with
            # the full per-request objective — the sweep then co-optimizes
            # (B, policy, max_wait, shed) and reports per-class miss rates
            if self.slo_classes and getattr(planner, "consumes_classes", False):
                objective = dataclasses.replace(
                    objective,
                    slo_classes=self.slo_classes,
                    batch_size=self.serving_batch_size,
                    max_waits=self.max_wait_candidates,
                    sheds=self.shed_candidates,
                )
        # the coded race applies to BOTH modes (batch completion and
        # sojourn); gate on consumes_load as the "simulated planner"
        # capability — the closed-form planner cannot score coded cells
        if self.coding_candidates and planner.consumes_load:
            objective = dataclasses.replace(
                objective, coding=self.coding_candidates
            )
        return objective

    def _cooldown_waived(self) -> bool:
        """Whether re-plan pacing is waived by the measured-time budget.

        True when ``TunerConfig.replan_time_budget`` is set and the last
        measured ``planner.plan()`` call came in at or under it: the
        cooldown exists to amortize expensive sweeps, and once the sweep
        is measured-cheap pacing only delays reactions to drift.  Hysteresis still gates the MOVES —
        only the attempt rate is freed.  The first attempt after
        construction is never waived (no measurement yet), so a slow
        slow sweep can never sneak through on an optimistic default.
        """
        budget = self.config.replan_time_budget
        return (
            budget is not None
            and self.last_replan_seconds is not None
            and self.last_replan_seconds <= budget
        )

    def maybe_replan(self) -> Optional[RescalePlan]:
        """Fit, delegate the B decision to the Planner, and emit a rescale
        plan if the predicted win clears the Objective's hysteresis."""
        if not self._cooldown_waived():
            if self._step - self._last_replan < self.config.cooldown_steps:
                return None
            # the cooldown also paces plan EVALUATIONS that did not move B:
            # a load-aware sweep is ~10^2 slower than the closed forms, and
            # re-scoring the whole spectrum after every observation would
            # make telemetry ingestion O(sweep).  Attempts that bailed for
            # lack of data (no fit yet) do not count.
            if self._step - self._last_attempt < self.config.cooldown_steps:
                return None
        if self.n_samples < self.config.min_samples:
            return None
        x, c = self.window_observations()
        if (~c).sum() == 0:
            return None
        planner = self.planner
        use_empirical = planner.consumes_empirical
        self.last_gof = None
        fit: Optional[FitResult] = None
        if not use_empirical:
            fit = self.fit()
            if fit is None:
                return None
            # goodness-of-fit gate: a parametric fit the window rejects must
            # not drive the B decision — reroute THIS attempt through the
            # empirical path (the primary planner stays installed; a later
            # well-fitting window flows back to it automatically)
            if self.config.gof_alpha is not None:
                self.last_gof = goodness_of_fit(
                    x, fit.dist, c, alpha=self.config.gof_alpha
                )
                if self.last_gof.rejected:
                    planner = self._empirical_fallback_planner()
                    use_empirical = True
        objective = self.objective(planner)
        if use_empirical:
            # the spec's dist is the window itself (KM ECDF); rates are
            # dropped — EmpiricalPlanner quantifies distributional
            # uncertainty, not per-worker skew.  On the empirical-PRIMARY
            # path no parametric MLE runs at all (the fit would be thrown
            # away); the RescalePlan's fit record is computed lazily below,
            # only when a move is actually emitted.
            spec = ClusterSpec(
                n_workers=self.plan.n_data,
                dist=self.empirical_dist(),
                batch_divisor=self.batch_divisor,
            )
        else:
            spec = self.cluster_spec(fit)
        t0 = time.perf_counter()
        plan = planner.plan(spec, objective)
        self.last_replan_seconds = time.perf_counter() - t0
        self.last_plan = plan
        self._last_attempt = self._step
        if plan.n_batches == self.plan.n_batches:
            return None
        # current B absent from the sweep means it is no longer feasible
        # (e.g. a new batch_divisor constraint): the move is FORCED, so it
        # bypasses hysteresis — including any observed-sojourn baseline —
        # and reports an infinite predicted win.
        cur = plan.predicted_at(self.plan.n_batches)
        if cur is None:
            improvement = math.inf
        else:
            baselines = [cur]
            if objective.load_aware:
                # sojourn telemetry is the ground truth for what the current
                # B costs.  The predicted win must clear hysteresis against
                # BOTH the model's CRN-consistent estimate of the current B
                # (which kills ping-pong between near-tied candidates) and
                # the latency requests actually experienced (which kills
                # moves justified only by model optimism).  The window is
                # cleared on apply() — it must describe the CURRENT
                # configuration, not the drain transient of the last move —
                # so require a refilled window before trusting its quantiles.
                observed = self.observed_sojourn(objective.metric)
                n_observed = sum(s.size for s in self._sojourns)
                if (
                    observed is not None
                    and n_observed >= self.config.min_samples
                ):
                    baselines.append(observed)
            cur = min(baselines)
            improvement = 1.0 - plan.score / max(cur, 1e-30)
        # SLO breach waives hysteresis: while the observed deadline-miss
        # rate exceeds the target, ANY predicted win justifies moving (the
        # cooldown still paces the attempts, so near-ties cannot ping-pong
        # faster than one move per cooldown window)
        threshold = self.config.improvement_threshold
        miss_rate = self.observed_miss_rate
        if (
            self.config.miss_rate_target is not None
            and miss_rate is not None
            and miss_rate > self.config.miss_rate_target
        ):
            threshold = 0.0
        # a PER-CLASS target in breach waives hysteresis too: the global
        # rate can look healthy while a premium tenant is starving
        if self._class_target_breached():
            threshold = 0.0
        if improvement < threshold:
            return None
        self._last_replan = self._step
        if fit is None:  # empirical-primary path: fit only for the record
            fit = self.fit()
        return RescalePlan(
            old_batches=self.plan.n_batches,
            new_batches=plan.n_batches,
            predicted_old=cur if cur is not None else math.inf,
            predicted_new=plan.score,
            fit=fit,
            step=self._step,
            plan=plan,
        )

    def apply(self, plan: RescalePlan) -> ReplicationPlan:
        """Commit a re-plan (the caller re-factors the mesh + pipeline)."""
        self.plan = ReplicationPlan(
            n_data=self.plan.n_data, n_batches=plan.new_batches
        )
        # sojourn + miss telemetry describe the configuration they were
        # measured under; keeping the old B's (and the move's drain-
        # transient) observations would let every move justify the next one
        self._sojourns.clear()
        self._misses.clear()
        self._class_misses.clear()
        return self.plan
