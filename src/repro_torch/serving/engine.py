"""Replicated serving engine — the paper's System1 as a discrete-event
request runtime, on a torch device.

Requests arrive under a configurable :mod:`~repro_torch.serving.arrivals`
process (Poisson / MMPP-bursty / deterministic / replayed trace), queue at
the :class:`~repro_torch.serving.queueing.EventDrivenMaster` (FIFO or priority
admission, batch formation under a max-wait + max-size policy), and each
formed batch is dispatched to a replica-set of r = N/B server groups — the
FASTEST replica's response completes the batch and the rest are cancelled
(the paper's rule).  A request's reported latency is its SOJOURN: queue
wait + service, the metric users actually feel under heavy traffic.

The engine

* actually executes prefill + decode on a (small) model for each completed
  batch (outputs are real tokens), driven off the event clock: on the card
  through the ``flash_attention`` and ``decode_attention`` kernels, and for
  the hybrid family through ``ssd_scan`` too;
* draws per-replica service times from the calibrated straggler model;
* feeds the spectrum tuner three telemetry streams — per-replica service
  times (censored for cancelled replicas), the measured batch-formation
  rate, and per-request sojourns — so B adapts online through the
  load-aware ``ClusterSpec -> Plan`` control plane: re-plans are scored by
  simulated sojourn at the OBSERVED arrival rate and applied at a
  drain-then-swap quiesce point.  Simulated re-plans run the
  ``sojourn_cells`` kernel on the card (and, with tenant classes, the
  serving sweep on it).

The lock-step API survives as a thin compatibility shim:
:meth:`ReplicatedServingEngine.serve_round` drives the event loop for one
synchronized round (every request pre-arrived, one pre-formed batch per
idle replica-set) and reproduces the legacy engine's latencies draw-for-draw
— while also fixing the legacy remainder bug (``n_requests % B != 0``
silently dropped the tail; see :func:`~repro_torch.serving.queueing
.partition_requests`).

As ``repro.serving.engine``, with one device for the whole engine
(``ServeEngineConfig.device``: ``None`` means CUDA and raises without a
card; ``"cpu"`` runs the kernels' plain versions).  The schedule — arrivals,
service draws, every dispatch and re-plan — comes from numpy at the
reference's seeds and does not depend on the device or on
``execute_model``.  The model is ``reduced_config(get_config(arch))`` with
weights from a ``torch.Generator`` seeded with ``seed``; each request's
prompt comes from its own CPU ``torch.Generator`` (:meth:`ReplicatedServingEngine
._prompts`), so what a request generates does not depend on how it was
batched or replicated.  Weights and prompts differ from the reference's,
whose come from JAX keys.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core import (
    ClusterSpec,
    CodingCandidate,
    Objective,
    PolicyCandidate,
    ReplicationPlan,
    ShedPolicy,
    ShiftedExponential,
    SloClass,
    StragglerTuner,
    TunerConfig,
    make_planner,
)
from ..core.order_stats import ServiceDistribution
from ..core.spectrum import Metric
from ..device import resolve_device
from ..launch.serve import generate
from ..models import init_params
from .arrivals import ArrivalProcess, make_arrivals
from .queueing import (
    BatchJob,
    ClonePolicy,
    EventDrivenMaster,
    HedgedDispatchPolicy,
    QueuePolicy,
    RelaunchPolicy,
    Request,
    StragglerPolicy,
    job_observations,
    partition_requests,
)

__all__ = ["ServeEngineConfig", "RequestStats", "ReplicatedServingEngine"]

_NO_TOKENS = np.empty(0, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class ServeEngineConfig:
    arch: str = "qwen2-0.5b"
    n_server_groups: int = 8  # the paper's N
    n_batches: int = 4  # the paper's B (replication r = N/B)
    batch_size: int = 4  # requests per batch (queueing: max batch size)
    prompt_len: int = 16
    gen_tokens: int = 8
    max_len: int = 64
    # service-time model per REQUEST-UNIT of work (scaled by batch tokens)
    delta: float = 0.02
    mu: float = 50.0
    seed: int = 0
    # control plane: the ONE shared Metric literal + planner mode; B adapts
    # online through Planner.plan when ``tuner`` is on, and ``plan_initial``
    # lets the planner also pick the STARTING B from the ClusterSpec.
    # 'empirical' plans over bootstrap resamples of the observed service
    # times instead of a parametric fit (core.planner.EmpiricalPlanner).
    tuner: bool = False
    metric: Metric = "mean"
    planner_mode: str = "analytic"  # 'analytic' | 'simulate' | 'empirical'
    plan_initial: bool = False
    # torch device of the whole engine: the simulated/empirical planners'
    # sweeps, the tuner's re-plans and the model.  None means "cuda" (which
    # must be present); "cpu" runs the kernels' plain PyTorch versions.
    device: Optional[str] = None
    # wall-clock budget (seconds) for one re-plan: when the tuner measures
    # planner.plan() at or under this, re-plan cooldown pacing is waived
    # and hysteresis alone gates moves (TunerConfig.replan_time_budget).
    # None keeps fixed cooldown.
    replan_time_budget: Optional[float] = None
    # goodness-of-fit gate: KS-test the parametric fit against the observed
    # service-time window at this significance; a rejected fit makes the
    # tuner re-plan through the empirical path for that attempt (None = off)
    gof_alpha: Optional[float] = None
    # --- discrete-event serving (arrival + queue knobs) ---------------------
    # offered load, either as REQUESTS per unit sim-time or as a fraction of
    # the fleet's no-replication capacity; either one makes the planner
    # objective load-aware (scored on sojourn, needs a simulation-capable
    # planner_mode: 'simulate' or 'empirical')
    # NOTE: the load-aware objective converts the REQUEST rate to a
    # batch-JOB rate as arrival_rate / batch_size, i.e. it assumes full
    # batches.  With a tight max_wait (or drop_expired) the master forms
    # partial batches and the true job rate is higher; the tuner's
    # observe_load telemetry corrects the estimate online when tuner=True.
    arrival_rate: Optional[float] = None
    utilization: Optional[float] = None
    arrival_kind: str = "poisson"  # 'poisson'|'mmpp'|'deterministic'|'trace'
    # recorded arrival offsets for arrival_kind='trace' (required there;
    # alternatively pass any ArrivalProcess straight to serve())
    arrival_offsets: Optional[tuple[float, ...]] = None
    max_wait: float = math.inf  # batch-formation deadline (sim-time units)
    queue_discipline: str = "fifo"  # 'fifo' | 'priority' | 'edf' | 'wfq'
    # --- multi-tenant SLO serving -------------------------------------------
    # tenant classes (core.SloClass): arrivals are labeled by class share,
    # per-class deadlines/weights drive EDF/WFQ and per-class miss
    # telemetry, and (with a 'simulate' planner) re-plans run the SERVING
    # sweep — every (B, policy, max_wait, shed) cell scored per request,
    # the winner's max_wait/shed adopted live.  Requires offered load
    # (arrival_rate or utilization).
    slo_classes: Optional[tuple[SloClass, ...]] = None
    # formation-deadline candidates for the serving sweep's max_wait axis
    # (default: just the config's max_wait)
    max_wait_candidates: Optional[tuple[float, ...]] = None
    # admission-control candidates for the serving sweep's shed axis
    # (core.ShedPolicy); the no-shed baseline is always raced alongside
    shed_candidates: Optional[tuple[ShedPolicy, ...]] = None
    # --- speculative re-dispatch (clone-attack straggler mitigation) --------
    # launch a clone of a batch onto an idle replica-set when its first
    # response is later than this quantile of the fitted min-over-replicas
    # service distribution (None = no speculation); clone_budget caps the
    # clones per batch job.  The same quantile seeds the planner objective,
    # so plan_initial / tuner re-plans score candidate B with speculation on.
    speculation_quantile: Optional[float] = None
    clone_budget: int = 1
    # which mitigation the live trigger drives: 'clone' copies a late batch
    # onto an idle set (original keeps running), 'relaunch' cancels the late
    # attempt and re-draws fresh on the same set, 'hedged' dispatches a
    # hedge_fraction of jobs to two sets up front (no trigger involved),
    # 'none' disables mitigation regardless of speculation_quantile
    straggler_policy: str = "clone"
    hedge_fraction: float = 1.0  # fraction of jobs hedged ('hedged' only)
    # adaptive portfolio: PolicyCandidate tuple the tuner's load-aware
    # re-plans score per candidate B; the winner lands on Plan.policy and
    # the engine adopts it live (the online policy-switch loop).  Overrides
    # the speculation_quantile-seeded trigger sweep in re-plan objectives.
    policy_candidates: Optional[tuple[PolicyCandidate, ...]] = None
    # coded-computation portfolio: CodingCandidate tuple every planner
    # objective (initial plan + tuner re-plans) races against the
    # replication sweep on shared CRN draws; a strict winner lands on
    # Plan.coding.  The event-driven master keeps serving replicated
    # batches — the coded pick is surfaced as telemetry/provenance (the
    # coded data plane lives in the cluster runtime), so this knob is the
    # control-plane view of the replication-vs-coding decision.  Needs a
    # simulation-capable planner_mode ('simulate' | 'empirical').
    coding_candidates: Optional[tuple[CodingCandidate, ...]] = None
    # --- deadlines / SLOs ---------------------------------------------------
    # uniform RELATIVE deadline applied to every request (arrival + deadline;
    # None = no SLO).  Per-request deadlines go through serve(deadlines=...).
    deadline: Optional[float] = None
    drop_expired: bool = False  # shed requests already past their deadline
    # observed miss rate above this waives re-plan hysteresis (None = off)
    miss_rate_target: Optional[float] = None
    # skip real prefill/decode (latency-only experiments, fast tests)
    execute_model: bool = True


@dataclasses.dataclass
class RequestStats:
    request_id: int
    arrival: float
    completion: float
    tokens: np.ndarray
    dispatched: float = math.nan
    deadline: float = math.inf  # absolute SLO deadline (inf = none)
    dropped: bool = False  # shed (drop-on-expiry / admission cap), never served
    slo: str = ""  # tenant class name ("" = untagged)

    @property
    def latency(self) -> float:
        """Sojourn: queue wait + service (== completion - arrival)."""
        return self.completion - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.dispatched - self.arrival

    @property
    def service(self) -> float:
        return self.completion - self.dispatched

    @property
    def missed_deadline(self) -> bool:
        """True when a deadline-carrying request was late or dropped."""
        if not math.isfinite(self.deadline):
            return False
        return self.dropped or self.completion > self.deadline


class ReplicatedServingEngine:
    def __init__(self, sc: ServeEngineConfig):
        self.sc = sc
        self.device = resolve_device(sc.device)
        self.dist: ServiceDistribution = ShiftedExponential(
            delta=sc.delta, mu=sc.mu
        )
        # the serving control plane hangs off ONE ClusterSpec + Planner
        self.cluster_spec = ClusterSpec(
            n_workers=sc.n_server_groups, dist=self.dist
        )
        # the LIVE straggler policy: starts at the config's, and adopts the
        # candidate chosen by each load-aware re-plan (which may be None —
        # the planner found plain replication better at the new B).  Set
        # before the objective/tuner: both are seeded from it.
        self.policy: Optional[PolicyCandidate] = self._initial_policy()
        # multi-tenant serving needs offered load (the per-request sweep is
        # load-aware by construction) and, for planning, the simulated
        # sweep — the analytic/empirical planners cannot score the
        # admission/WFQ/shedding model
        if sc.slo_classes:
            if sc.arrival_rate is None and sc.utilization is None:
                raise ValueError(
                    "slo_classes needs offered load: set ServeEngineConfig"
                    ".arrival_rate or .utilization"
                )
            if (sc.tuner or sc.plan_initial) and sc.planner_mode != "simulate":
                raise ValueError(
                    "slo_classes re-plans run the serving sweep; use "
                    "planner_mode='simulate'"
                )
            if sc.coding_candidates:
                raise ValueError(
                    "slo_classes and coding_candidates are mutually "
                    "exclusive: the serving sweep scores replication "
                    "policies only"
                )
        else:
            if sc.queue_discipline == "wfq":
                raise ValueError(
                    "queue_discipline='wfq' needs slo_classes (the class "
                    "weights are the WFQ shares)"
                )
            if sc.max_wait_candidates or sc.shed_candidates:
                raise ValueError(
                    "max_wait_candidates / shed_candidates only apply with "
                    "slo_classes"
                )
        # LIVE serving knobs: start at the config's, adopt each serving
        # re-plan's winning (max_wait, shed) cell — _queue_policy() reads
        # these, so the next formed master (and, via the reconfig/
        # swap_policy path, the running one) runs what the sweep scored
        self.max_wait: float = sc.max_wait
        self.shed: Optional[ShedPolicy] = None
        # job-arrival offsets for non-Poisson traffic, filled by
        # _build_objective and threaded into tuner re-plans (bugfix: sweeps
        # used to assume Poisson arrivals whatever the engine actually ran)
        self._job_arrival_offsets: Optional[tuple[float, ...]] = None
        self.objective = self._build_objective()
        # online re-plans re-score the whole sweep (sojourn-simulated when
        # the objective is load-aware), so size it like the tuner's default
        # sim budget rather than the offline 20k-trial analysis default
        self.planner = make_planner(
            mode=sc.planner_mode, n_trials=4_000, seed=sc.seed,
            device=str(self.device),
        )
        # the latest coded pick (Plan.coding) from any planner call: None
        # until a coding_candidates objective adopts a scheme; telemetry
        # provenance for run_load (the coded data plane is the cluster
        # runtime's job)
        self.last_coding: Optional[CodingCandidate] = None
        if sc.plan_initial:
            initial = self.planner.plan(self.cluster_spec, self.objective)
            n_batches = initial.n_batches
            self.last_coding = initial.coding
            if sc.slo_classes:
                # the serving plan decides policy/max_wait/shed too — run
                # from the start what the winning cell assumed
                self._adopt_serving(initial)
        else:
            n_batches = sc.n_batches
        self.plan = ReplicationPlan(
            n_data=sc.n_server_groups, n_batches=n_batches
        )
        self.rng = np.random.default_rng(sc.seed + 1)
        self._arrival_rng = np.random.default_rng(sc.seed + 2)
        # one observe() per completed batch: re-plan from >= 64 service
        # samples and at most every 16 batches — load-aware sweeps are
        # ~10^2 slower than the analytic closed form, and a fit from fewer
        # samples makes B oscillate under bursty formation telemetry
        self.tuner = StragglerTuner(
            self.plan,
            TunerConfig(
                window_steps=256, min_samples=64, cooldown_steps=16,
                # miss telemetry arrives one entry per resolved REQUEST
                # (served and dropped paths alike), so the window that
                # covers 256 batches of it is 256 x the batch size
                miss_window=256 * sc.batch_size,
                metric=sc.metric, miss_rate_target=sc.miss_rate_target,
                gof_alpha=sc.gof_alpha, device=str(self.device),
                replan_time_budget=sc.replan_time_budget,
            ),
            planner=self.planner,
            job_load=self._work(sc.batch_size),
            # load-aware re-plans score candidate B with the SAME straggler
            # mitigation the master runs (else a fleet stable only because
            # it mitigates looks saturated and re-plans to no-replication):
            # an explicit portfolio when configured, a single-candidate
            # portfolio for relaunch/hedged, the legacy clone-trigger sweep
            # otherwise
            **self._tuner_decision_kwargs(),
            arrival_offsets=self._job_arrival_offsets,
        )
        self.clock = 0.0
        self._next_id = 0
        self.last_master: Optional[EventDrivenMaster] = None
        self._tokens: dict[int, np.ndarray] = {}
        self._formations: deque[float] = deque(maxlen=32)
        if sc.execute_model:
            self.cfg = reduced_config(get_config(sc.arch))
            self.params = init_params(
                torch.Generator(device=self.device).manual_seed(sc.seed),
                self.cfg, self.device,
            )
        else:
            self.cfg = None
            self.params = None

    # -- straggler policy (live state) ---------------------------------------
    def _initial_policy(self) -> Optional[PolicyCandidate]:
        """The config's straggler mitigation as a PolicyCandidate (None =
        mitigation off)."""
        sc = self.sc
        if sc.straggler_policy not in ("none", "clone", "relaunch", "hedged"):
            raise ValueError(
                "ServeEngineConfig.straggler_policy must be 'none', "
                f"'clone', 'relaunch' or 'hedged', got {sc.straggler_policy!r}"
            )
        if sc.straggler_policy == "none":
            return None
        if sc.straggler_policy == "hedged":
            pol = PolicyCandidate("hedged", hedge_fraction=sc.hedge_fraction)
            return pol if pol.enabled else None
        if sc.speculation_quantile is None:
            return None  # trigger-driven kinds need a trigger
        return PolicyCandidate(
            sc.straggler_policy, quantile=sc.speculation_quantile
        )

    @property
    def speculation_quantile(self) -> Optional[float]:
        """The live CLONE trigger (legacy mirror — None whenever the live
        policy is anything other than a trigger-driven clone, same rule as
        ``Plan.speculation_quantile``)."""
        pol = self.policy
        if pol is not None and pol.kind == "clone":
            return pol.quantile
        return None

    @speculation_quantile.setter
    def speculation_quantile(self, q: Optional[float]) -> None:
        # legacy shim: assigning a trigger installs/uninstalls a clone policy
        self.policy = (
            PolicyCandidate("clone", quantile=float(q))
            if q is not None
            else None
        )

    def _trigger_quantile(self) -> Optional[float]:
        """The live policy's late trigger (clone OR relaunch; None = off)."""
        pol = self.policy
        if pol is not None and pol.kind in ("clone", "relaunch"):
            return pol.quantile
        return None

    def _adopt_policy(self, plan) -> None:
        """Run the mitigation the winning sweep score assumed — including
        'no mitigation at this B' (a disabled/None candidate)."""
        pol = plan.policy
        self.policy = pol if pol is not None and pol.enabled else None

    def _adopt_serving(self, plan) -> None:
        """Adopt a serving plan's FULL decision: mitigation policy plus the
        winning (max_wait, shed) cell."""
        self._adopt_policy(plan)
        if plan.max_wait is not None:
            self.max_wait = float(plan.max_wait)
        shed = plan.shed
        self.shed = shed if shed is not None and shed.kind != "none" else None

    def _tuner_decision_kwargs(self) -> dict:
        """Straggler-mitigation axis of tuner re-plan objectives (mirrors
        ``_build_objective``'s choice)."""
        sc = self.sc
        coding = (
            {"coding_candidates": tuple(sc.coding_candidates)}
            if sc.coding_candidates
            else {}
        )
        if sc.slo_classes:
            # serving sweep: the (max_wait, shed) axes ride along, and the
            # mitigation axis must be a portfolio (the serving sweep has no
            # legacy clone-trigger path) — the live policy becomes a
            # single-candidate portfolio when none is configured
            serving = {
                "slo_classes": tuple(sc.slo_classes),
                "serving_batch_size": sc.batch_size,
                "max_wait_candidates": (
                    tuple(sc.max_wait_candidates)
                    if sc.max_wait_candidates
                    else (sc.max_wait,)
                ),
                "shed_candidates": (
                    tuple(sc.shed_candidates) if sc.shed_candidates else None
                ),
            }
            if sc.policy_candidates:
                serving["policy_candidates"] = tuple(sc.policy_candidates)
            elif self.policy is not None:
                serving["policy_candidates"] = (self.policy,)
            return serving
        if sc.policy_candidates:
            return {"policy_candidates": tuple(sc.policy_candidates), **coding}
        pol = self.policy
        if pol is not None and pol.kind in ("relaunch", "hedged"):
            return {"policy_candidates": (pol,), **coding}
        return {
            "speculation_quantiles": (
                (pol.quantile,)
                if pol is not None and pol.kind == "clone"
                else None
            ),
            **coding,
        }

    # -- objective / arrivals ------------------------------------------------
    def _work(self, n_reqs: int) -> float:
        """Units of data one batch of ``n_reqs`` requests carries."""
        return n_reqs * (self.sc.prompt_len + self.sc.gen_tokens) / 100.0

    def _job_offsets_for(self, request_rate: float) -> Optional[tuple[float, ...]]:
        """Batch-JOB arrival offsets implied by a non-Poisson config.

        The load-aware sweeps default to Poisson job arrivals; when the
        engine runs MMPP/bursty/deterministic/trace traffic that default
        silently mis-scores every candidate (burstiness inflates queueing
        far beyond the Poisson prediction).  Sampling the configured
        process and keeping every ``batch_size``-th arrival (the instant a
        full batch forms) gives the sweep the job stream the master will
        actually see.  None for Poisson (the sweep's native default).
        """
        sc = self.sc
        if sc.arrival_kind == "poisson":
            return None
        if sc.arrival_kind == "trace":
            if sc.arrival_offsets is None:
                return None
            times = np.asarray(sc.arrival_offsets, dtype=float)
        else:
            proc = make_arrivals(sc.arrival_kind, rate=request_rate)
            # dedicated stream: must not perturb serve()'s arrival draws
            rng = np.random.default_rng((sc.seed, 0xA221))
            times = proc.sample(rng, 2_048 * sc.batch_size)
        jobs = times[sc.batch_size - 1 :: sc.batch_size]
        if jobs.size < 2:
            return None
        return tuple(float(t) for t in jobs)

    def _request_offsets_for(
        self, request_rate: float
    ) -> Optional[tuple[float, ...]]:
        """REQUEST arrival offsets implied by a non-Poisson config.

        The serving-sweep counterpart of :meth:`_job_offsets_for`: the
        multi-tenant scorer replays the per-request trace and forms its
        own batches, so no job collapsing happens here.  Short traces are
        cycled by the sweep (TraceArrivals replay rule).
        """
        sc = self.sc
        if sc.arrival_kind == "trace":
            if sc.arrival_offsets is None:
                return None
            times = np.asarray(sc.arrival_offsets, dtype=float)
        else:
            proc = make_arrivals(sc.arrival_kind, rate=request_rate)
            # dedicated stream: must not perturb serve()'s arrival draws
            rng = np.random.default_rng((sc.seed, 0xA222))
            times = proc.sample(rng, 2_048 * sc.batch_size)
        if times.size < 2:
            return None
        return tuple(float(t) for t in times)

    def _build_objective(self) -> Objective:
        sc = self.sc
        if sc.arrival_rate is not None and sc.utilization is not None:
            raise ValueError(
                "give ServeEngineConfig.arrival_rate OR .utilization, not "
                "both (same rule as Objective)"
            )
        load_aware = sc.arrival_rate is not None or sc.utilization is not None
        pol = self.policy
        policies: Optional[tuple[PolicyCandidate, ...]] = None
        spec_qs: Optional[tuple[float, ...]] = None
        if load_aware:
            # the planner scores candidate B under the SAME mitigation the
            # master runs: an explicit portfolio when configured, a single-
            # candidate portfolio for relaunch/hedged, the legacy clone-
            # trigger sweep otherwise
            if sc.policy_candidates:
                policies = tuple(sc.policy_candidates)
            elif pol is not None and pol.kind in ("relaunch", "hedged"):
                policies = (pol,)
            elif pol is not None and pol.kind == "clone":
                # the serving sweep has no legacy clone-trigger path: a live
                # clone policy rides as a single-candidate portfolio there
                if sc.slo_classes:
                    policies = (pol,)
                else:
                    spec_qs = (pol.quantile,)
        if sc.coding_candidates and sc.planner_mode == "analytic":
            raise ValueError(
                "coding_candidates needs a simulation-capable planner_mode "
                "('simulate' | 'empirical'): the closed-form planner cannot "
                "score coded candidates"
            )
        objective = Objective(
            metric=sc.metric,
            arrival_rate=(
                sc.arrival_rate / sc.batch_size
                if sc.arrival_rate is not None
                else None
            ),
            utilization=sc.utilization,
            job_load=self._work(sc.batch_size),
            speculation_quantiles=spec_qs,
            policies=policies,
            coding=(
                tuple(sc.coding_candidates) if sc.coding_candidates else None
            ),
        )
        if sc.slo_classes:
            objective = dataclasses.replace(
                objective,
                slo_classes=tuple(sc.slo_classes),
                batch_size=sc.batch_size,
                max_waits=(
                    tuple(sc.max_wait_candidates)
                    if sc.max_wait_candidates
                    else (sc.max_wait,)
                ),
                sheds=(
                    tuple(sc.shed_candidates) if sc.shed_candidates else None
                ),
            )
        if load_aware and sc.arrival_kind != "poisson":
            rate = (
                sc.arrival_rate
                if sc.arrival_rate is not None
                else objective.offered_rate(self.cluster_spec) * sc.batch_size
            )
            if sc.slo_classes:
                # the serving sweep is PER-REQUEST — it forms its own
                # batches per (max_wait, shed) cell — so it needs the raw
                # request trace.  Handing it the job-collapsed offsets
                # below would score every cell at 1/batch_size of the true
                # load, and B=1 "wins" the sweep of a fleet that is not
                # actually underloaded.  The default multitenant process is
                # Poisson-with-labels, exactly the sweep's internal
                # generator: attach nothing there, so tuner re-plans track
                # the OBSERVED rate instead of a trace pinned at build time.
                offs = (
                    None
                    if sc.arrival_kind == "multitenant"
                    else self._request_offsets_for(rate)
                )
            else:
                offs = self._job_offsets_for(rate)
            if offs is not None:
                self._job_arrival_offsets = offs
                objective = dataclasses.replace(objective, arrivals=offs)
        return objective

    def _request_rate(self) -> float:
        """Offered REQUEST arrival rate implied by the config."""
        sc = self.sc
        if sc.arrival_rate is not None:
            return sc.arrival_rate
        if sc.utilization is not None:
            return self.objective.offered_rate(self.cluster_spec) * sc.batch_size
        raise ValueError(
            "event-driven serving needs ServeEngineConfig.arrival_rate or "
            ".utilization (or pass an ArrivalProcess to serve())"
        )

    def _default_arrivals(self) -> ArrivalProcess:
        sc = self.sc
        if sc.arrival_kind == "trace":
            # a trace carries its own rate; the offsets are the config
            if sc.arrival_offsets is None:
                raise ValueError(
                    "arrival_kind='trace' needs ServeEngineConfig"
                    ".arrival_offsets (or pass an ArrivalProcess to serve())"
                )
            return make_arrivals(
                "trace", rate=1.0, offsets=sc.arrival_offsets
            )
        if sc.arrival_kind == "multitenant" and sc.slo_classes:
            # tenant shares come from the configured classes, so the
            # process's labels match the engine's class vocabulary
            return make_arrivals(
                "multitenant",
                rate=self._request_rate(),
                classes=tuple((c.name, c.share) for c in sc.slo_classes),
            )
        return make_arrivals(sc.arrival_kind, rate=self._request_rate())

    # -- real model work -----------------------------------------------------
    def _prompts(self, request_ids) -> torch.Tensor:
        """(n, prompt_len) prompts of these requests, on the engine's device.

        Each request's prompt is drawn on the CPU from its own
        ``torch.Generator``, seeded with ``((seed + 3) << 32) + request_id``
        (mod 2**64): ``prompt_len`` tokens of ``torch.randint(0, vocab)``.
        Keyed by request id, so WHAT is generated for a request is invariant
        to how traffic got batched or replicated.
        """
        sc = self.sc
        rows = [
            torch.randint(
                0, self.cfg.vocab_size, (sc.prompt_len,),
                generator=torch.Generator().manual_seed(
                    (((sc.seed + 3) << 32) + int(rid)) % (1 << 64)
                ),
            )
            for rid in request_ids
        ]
        return torch.stack(rows).to(self.device)

    def _generate(self, prompts: torch.Tensor) -> np.ndarray:
        """Greedy prefill + ``gen_tokens - 1`` decode steps
        (:func:`repro_torch.launch.serve.generate`), as (n, gen_tokens)
        int32 tokens on the host."""
        sc = self.sc
        gen = generate(self.cfg, self.params, prompts, sc.gen_tokens,
                       sc.max_len)
        return gen.tokens.cpu().numpy().astype(np.int32)

    def _generate_for_job(self, job: BatchJob) -> None:
        """Run real prefill+decode for a completed batch (event path)."""
        tokens = self._generate(
            self._prompts([req.request_id for req in job.requests])
        )
        for k, req in enumerate(job.requests):
            self._tokens[req.request_id] = tokens[k]

    # -- event-driven serving ------------------------------------------------
    def _service_sampler(self, job: BatchJob, group: int) -> np.ndarray:
        """Per-replica service draws for one dispatched batch."""
        work = self._work(job.size)
        return self.dist.scaled(work).sample(self.rng, self.plan.replication)

    def _speculation_threshold(self, job: BatchJob) -> float:
        """Late-quantile of the calibrated FIRST-RESPONSE distribution.

        The first response of a batch is the min over its r replicas'
        service draws; for the (shifted-)exponential straggler model that
        min keeps the shift and multiplies the rate by r, so its q-quantile
        is ``shift + -ln(1-q) / (r * mu)``.  A response later than this is
        late with model probability 1 - q — the clone/relaunch trigger.
        Reads the LIVE policy/plan, so a mid-run re-plan that changed B or
        disabled mitigation (inf threshold) takes effect on the next
        dispatch.
        """
        q = self._trigger_quantile()
        if q is None:
            return math.inf  # re-plan disabled mitigation mid-run
        scaled = self.dist.scaled(self._work(job.size))
        r = max(self.plan.replication, 1)
        shift = float(getattr(scaled, "delta", 0.0))
        return shift + (-math.log1p(-q)) / (scaled.mu * r)

    def _speculation_policy(self) -> Optional[StragglerPolicy]:
        """The master's straggler policy implied by the live candidate
        (None = mitigation off)."""
        pol = self.policy
        if pol is None or not pol.enabled:
            return None
        if pol.kind == "clone":
            return ClonePolicy(
                late_quantile=pol.quantile,
                max_clones=self.sc.clone_budget,
                threshold=self._speculation_threshold,
            )
        if pol.kind == "relaunch":
            return RelaunchPolicy(
                late_quantile=pol.quantile,
                max_relaunches=self.sc.clone_budget,
                threshold=self._speculation_threshold,
            )
        return HedgedDispatchPolicy(k=2, hedge_fraction=pol.hedge_fraction)

    def _queue_policy(self) -> QueuePolicy:
        """The master's queue policy from the LIVE serving state: config
        discipline + adopted ``max_wait`` + adopted shed policy ('expired'
        -> drop-on-expiry, 'cap' -> admission queue cap)."""
        sc = self.sc
        shed = self.shed
        return QueuePolicy(
            max_batch_size=sc.batch_size,
            max_wait=self.max_wait,
            discipline=sc.queue_discipline,
            drop_expired=(
                sc.drop_expired or (shed is not None and shed.kind == "expired")
            ),
            queue_cap=(
                shed.cap if shed is not None and shed.kind == "cap" else None
            ),
            class_weights=(
                tuple((c.name, c.weight) for c in sc.slo_classes)
                if sc.slo_classes and sc.queue_discipline == "wfq"
                else None
            ),
        )

    def _on_drop(self, req: Request) -> None:
        """Stream a shed request into the tuner AS IT HAPPENS (a drop-heavy
        SLO breach can then trigger a re-plan mid-stream).  PER-REQUEST and
        class-attributed, the same granularity as the served path — and
        only deadline-carrying requests count (a cap-shed of a best-effort
        request is lost work, not a deadline miss)."""
        if math.isfinite(req.deadline):
            self.tuner.observe_deadline_misses(1, 1, slo=req.slo)

    def _on_job_complete(self, job: BatchJob) -> Optional[dict]:
        """Telemetry + model work + (maybe) a drain-then-swap re-plan."""
        work = self._work(job.size)
        # censoring-correct per-replica telemetry across the live attempt,
        # relaunch-discarded attempts, and clones/hedges — shared with the
        # wall-clock cluster coordinator (queueing.job_observations)
        for times, censored in job_observations(job):
            self.tuner.observe(times / work, censored=censored)
        self.tuner.observe_sojourn(
            np.array([req.sojourn for req in job.requests])
        )
        # PER-REQUEST miss accounting, matching the drop path's granularity
        # (a batch-level (n_missed, n_batch) observation would weight each
        # batch equally however many requests it resolved — partial batches
        # then skew the windowed rate) and carrying the SLO class so
        # per-class breach detection sees served outcomes too
        for req in job.requests:
            if math.isfinite(req.deadline):
                self.tuner.observe_deadline_misses(
                    int(req.completion > req.deadline), 1, slo=req.slo
                )
        self._formations.append(job.formed_at)
        if len(self._formations) >= 2:
            # jobs complete out of formation order (slow sets finish late),
            # so span the window by max-min, not last-first
            span = max(self._formations) - min(self._formations)
            if span > 0:
                self.tuner.observe_load((len(self._formations) - 1) / span)
        if self.sc.execute_model:
            self._generate_for_job(job)
        if self.sc.tuner:
            rp = self.tuner.maybe_replan()
            if rp is not None:
                self.plan = self.tuner.apply(rp)
                # adopt the mitigation the winning score assumed: when the
                # re-plan swept (B, policy) or (B, trigger) cells, run what
                # it scored — including "don't mitigate at this B" (None)
                if rp.plan is not None and rp.plan.objective.coding:
                    self.last_coding = rp.plan.coding
                if rp.plan is not None and rp.plan.objective.slo_classes:
                    # serving re-plan: adopt the whole (policy, max_wait,
                    # shed) cell and ship the new queue policy to the
                    # quiesce point alongside the new fabric
                    self._adopt_serving(rp.plan)
                    return {
                        "n_groups": self.plan.n_batches,
                        "policy": self._queue_policy(),
                    }
                if rp.plan is not None and rp.plan.objective.policies:
                    self._adopt_policy(rp.plan)
                elif (
                    rp.plan is not None
                    and rp.plan.objective.speculation_quantiles
                ):
                    self.speculation_quantile = rp.plan.speculation_quantile
                return {"n_groups": self.plan.n_batches}
            # no B move, but the last evaluated sweep may still have found
            # a better policy/trigger AT the current B — adopting it needs
            # no drain/reconfig, so it is free (cooldown paces evaluations)
            lp = self.tuner.last_plan
            if lp is not None and lp.objective.coding:
                self.last_coding = lp.coding
            if lp is not None and lp.n_batches == self.plan.n_batches:
                if lp.objective.slo_classes:
                    self._adopt_serving(lp)
                    # same-B adoption needs no drain: max_wait/cap are
                    # scalar knobs the live master swaps in place
                    if self.last_master is not None:
                        self.last_master.swap_policy(self._queue_policy())
                elif lp.objective.policies:
                    self._adopt_policy(lp)
                elif lp.objective.speculation_quantiles:
                    self.speculation_quantile = lp.speculation_quantile
        return None

    def serve(
        self,
        n_requests: int,
        arrivals: Optional[ArrivalProcess] = None,
        deadlines: Optional[np.ndarray] = None,
        priorities: Optional[np.ndarray] = None,
    ) -> list[RequestStats]:
        """Serve ``n_requests`` arriving under ``arrivals`` (default: the
        config's process at the configured offered load) through the
        event-driven master; returns per-request sojourn stats.

        ``deadlines`` (per-request, RELATIVE to arrival) overrides the
        config's uniform ``deadline``; ``priorities`` feeds the
        ``'priority'`` discipline.  Requests carrying deadlines drive EDF
        ordering, drop-on-expiry, and deadline-miss telemetry.

        With ``slo_classes`` every arrival is labeled with a tenant class —
        by the arrival process itself when it can
        (:meth:`~repro_torch.serving.arrivals.MultiTenantArrivals
        .sample_with_classes`), else by an independent share draw — and the
        class deadline applies where neither ``deadlines`` nor the config's
        uniform ``deadline`` does.
        """
        sc = self.sc
        process = arrivals if arrivals is not None else self._default_arrivals()
        labels: Optional[list[str]] = None
        if sc.slo_classes and hasattr(process, "sample_with_classes"):
            times, labels = process.sample_with_classes(
                self._arrival_rng, n_requests, start=self.clock
            )
        else:
            times = process.sample(
                self._arrival_rng, n_requests, start=self.clock
            )
            if sc.slo_classes:
                shares = np.array(
                    [c.share for c in sc.slo_classes], dtype=float
                )
                idx = self._arrival_rng.choice(
                    len(shares), size=n_requests, p=shares / shares.sum()
                )
                labels = [sc.slo_classes[i].name for i in idx]
        if deadlines is None and sc.deadline is not None:
            deadlines = np.full(n_requests, sc.deadline)
        if deadlines is not None and len(deadlines) != n_requests:
            raise ValueError(
                f"deadlines length {len(deadlines)} != {n_requests}"
            )
        if priorities is not None and len(priorities) != n_requests:
            raise ValueError(
                f"priorities length {len(priorities)} != {n_requests}"
            )
        class_deadline = (
            {c.name: c.deadline for c in sc.slo_classes}
            if sc.slo_classes
            else {}
        )

        def _deadline(i: int, t: float) -> float:
            if deadlines is not None:
                return t + float(deadlines[i])
            if labels is not None:
                rel = class_deadline.get(labels[i])
                if rel is not None:
                    return t + float(rel)
            return math.inf

        requests = [
            Request(
                request_id=self._next_id + i,
                arrival=float(t),
                deadline=_deadline(i, float(t)),
                priority=(
                    float(priorities[i]) if priorities is not None else 0.0
                ),
                slo=labels[i] if labels is not None else "",
            )
            for i, t in enumerate(times)
        ]
        self._next_id += n_requests
        master = EventDrivenMaster(
            n_groups=self.plan.n_batches,
            service_sampler=self._service_sampler,
            policy=self._queue_policy(),
            clock=self.clock,
            on_job_complete=self._on_job_complete,
            speculation=self._speculation_policy(),
            # a dropped request resolved as a miss without reaching any job
            # callback: stream it into the tuner AS IT HAPPENS, per request
            # and class-attributed (see _on_drop)
            on_drop=self._on_drop,
        )
        self._tokens = {}
        # visible to _on_job_complete DURING the run: same-B serving
        # re-plans swap the live master's queue policy in place
        self.last_master = master
        for req in requests:
            master.submit(req)
        master.run()
        self.clock = master.clock
        return [
            RequestStats(
                request_id=req.request_id,
                arrival=req.arrival,
                completion=req.completion,
                tokens=self._tokens.get(req.request_id, _NO_TOKENS),
                dispatched=req.dispatched,
                deadline=req.deadline,
                dropped=req.dropped,
                slo=req.slo,
            )
            for req in requests
        ]

    def run_load(
        self,
        n_requests: int = 512,
        arrivals: Optional[ArrivalProcess] = None,
        deadlines: Optional[np.ndarray] = None,
    ) -> dict:
        """Event-driven driver: serve a request stream, report sojourn
        quantiles plus SLO/speculation telemetry (the serving twin of
        :meth:`run`).  Sojourn quantiles cover SERVED requests only;
        ``deadline_miss_rate`` covers every deadline-carrying request
        (dropped ones count as misses) and is None when no request carried
        a deadline.  With ``slo_classes``, ``class_stats`` breaks request
        counts, drops, miss rates, and sojourns down per tenant class."""
        start = self.clock
        stats = self.serve(n_requests, arrivals, deadlines=deadlines)
        served = [s for s in stats if not s.dropped]
        soj = np.array([s.latency for s in served])
        wait = np.array([s.queue_wait for s in served])
        with_deadline = [s for s in stats if math.isfinite(s.deadline)]
        miss_rate = (
            sum(s.missed_deadline for s in with_deadline) / len(with_deadline)
            if with_deadline
            else None
        )
        class_stats: Optional[dict] = None
        if self.sc.slo_classes:
            class_stats = {}
            for c in self.sc.slo_classes:
                cls = [s for s in stats if s.slo == c.name]
                cls_served = [s for s in cls if not s.dropped]
                cls_dl = [s for s in cls if math.isfinite(s.deadline)]
                cls_soj = np.array([s.latency for s in cls_served])
                class_stats[c.name] = {
                    "requests": len(cls),
                    "served": len(cls_served),
                    "dropped": len(cls) - len(cls_served),
                    "miss_rate": (
                        sum(s.missed_deadline for s in cls_dl) / len(cls_dl)
                        if cls_dl
                        else None
                    ),
                    "mean_sojourn": (
                        float(cls_soj.mean()) if len(cls_served) else math.nan
                    ),
                    "p99_sojourn": (
                        float(np.quantile(cls_soj, 0.99))
                        if len(cls_served)
                        else math.nan
                    ),
                }
        return {
            "requests": len(stats),
            "mean_sojourn": float(soj.mean()) if len(served) else math.nan,
            "p50_sojourn": (
                float(np.quantile(soj, 0.50)) if len(served) else math.nan
            ),
            "p99_sojourn": (
                float(np.quantile(soj, 0.99)) if len(served) else math.nan
            ),
            "p999_sojourn": (
                float(np.quantile(soj, 0.999)) if len(served) else math.nan
            ),
            "mean_queue_wait": (
                float(wait.mean()) if len(served) else math.nan
            ),
            "throughput": len(served) / max(self.clock - start, 1e-9),
            "final_B": self.plan.n_batches,
            "deadline_miss_rate": miss_rate,
            "n_dropped": len(stats) - len(served),
            "speculations": (
                self.last_master.speculations if self.last_master else 0
            ),
            "relaunches": (
                self.last_master.relaunches if self.last_master else 0
            ),
            "hedges": self.last_master.hedges if self.last_master else 0,
            "policy": self.policy.kind if self.policy is not None else "none",
            "max_wait": self.max_wait,
            "shed": self.shed.kind if self.shed is not None else "none",
            "class_stats": class_stats,
            "coding": (
                self.last_coding.describe()
                if self.last_coding is not None
                else "none"
            ),
            "stats": stats,
        }

    # -- one master round (compatibility shim) -------------------------------
    def serve_round(self, n_requests: Optional[int] = None) -> list[RequestStats]:
        """One SYNCHRONIZED round through the event loop (legacy API).

        Accept B*batch_size requests (default), all arriving at the current
        clock; one pre-formed batch per idle replica-set with service times
        pre-drawn in the legacy engine's RNG order — so zero-queueing
        latencies reproduce the lock-step engine draw-for-draw.  Unlike the
        legacy engine, the LAST batch absorbs the ``n_requests % B``
        remainder instead of silently dropping it.
        """
        sc = self.sc
        b = self.plan.n_batches
        r = self.plan.replication
        n_requests = n_requests or b * sc.batch_size
        arrival = self.clock

        if sc.execute_model:
            prompts = self._prompts(
                range(self._next_id, self._next_id + n_requests)
            )
        # batching unit: contiguous request slices (legacy layout, remainder
        # riding with the last batch); service times in the legacy RNG order
        per_batch = max(n_requests // b, 1)
        work = self._work(per_batch)
        times = self.dist.scaled(work).sample(self.rng, (b, r))
        slices = partition_requests(n_requests, b)
        # Exp/SExp scale affinely with load, so rescaling a row re-prices a
        # batch for its TRUE size from the same draws: the remainder-absorbing
        # last batch is charged its real work, while every equal-size row is
        # multiplied by exactly 1.0 (bit-for-bit with the legacy engine)
        row_work = np.array([
            self._work(hi - lo) if hi > lo else work for lo, hi in slices
        ])
        times = times * (row_work / work)[:, None]

        master = EventDrivenMaster(
            n_groups=b,
            service_sampler=self._service_sampler,
            clock=arrival,
        )
        jobs: list[tuple[int, BatchJob]] = []
        for bi, (lo, hi) in enumerate(slices):
            if lo >= hi:
                continue
            reqs = [
                Request(request_id=self._next_id + k, arrival=arrival)
                for k in range(lo, hi)
            ]
            jobs.append(
                (bi, master.submit_formed(reqs, at=arrival, service_times=times[bi]))
            )
        master.run()
        self._next_id += n_requests

        stats: list[RequestStats] = []
        for bi, job in jobs:
            lo, hi = slices[bi]
            tokens = self._generate(prompts[lo:hi]) if sc.execute_model else None
            for k, req in enumerate(job.requests):
                stats.append(
                    RequestStats(
                        request_id=req.request_id,
                        arrival=req.arrival,
                        completion=req.completion,
                        tokens=(
                            tokens[k] if tokens is not None else _NO_TOKENS
                        ),
                        dispatched=req.dispatched,
                    )
                )
        # legacy round clock: max over ALL replica-set minima, including
        # sets whose slice was empty (n_requests < B)
        self.clock = arrival + float(times.min(axis=1).max())
        # telemetry: per-unit times (normalized by each row's true work),
        # censored AT THE CANCELLATION TIME for unused replicas
        # (first-replica-wins cancels them at the batch minimum; their full
        # draws were never observable)
        batch_done = times.min(axis=1)
        observed = np.minimum(times, batch_done[:, None])
        used = np.zeros_like(times, dtype=bool)
        used[np.arange(b), times.argmin(axis=1)] = True
        self.tuner.observe(
            (observed / row_work[:, None]).reshape(-1),
            censored=~used.reshape(-1),
        )
        if self.sc.tuner:
            rp = self.tuner.maybe_replan()
            if rp is not None:
                self.plan = self.tuner.apply(rp)
        return stats

    def run(self, n_rounds: int = 5) -> dict:
        all_stats: list[RequestStats] = []
        for _ in range(n_rounds):
            all_stats.extend(self.serve_round())
        lat = np.array([s.latency for s in all_stats])
        return {
            "requests": len(all_stats),
            "mean_latency": float(lat.mean()),
            "p99_latency": float(np.quantile(lat, 0.99)),
            "throughput": len(all_stats) / max(self.clock, 1e-9),
            "final_B": self.plan.n_batches,
            "stats": all_stats,
        }
