"""Fault tolerance + straggler detection (control plane).

On a real pod the signals are host heartbeats and per-step barrier timings;
here the same logic runs against :class:`repro_torch.core.simulator.StepTimeSimulator`
so every policy is CPU-testable.

* :class:`StragglerDetector` — one-step-delayed control (DESIGN.md §2):
  flags workers whose recent service times are k-sigma/medians above the
  fleet, emits the ``alive`` mask consumed by the weighted psum.
* :class:`FaultManager` — tracks hard failures (missed heartbeats), decides
  between *mask* (batch still covered by surviving replicas) and *elastic
  restart* (a whole replica group lost).  Recovery B is NOT chosen here:
  :meth:`FaultManager.plan_recovery` builds a survivors-only
  :class:`~repro_torch.core.planner.ClusterSpec` and delegates to the unified
  :class:`~repro_torch.core.planner.Planner` control plane.

``FaultManager.device`` is the torch device of the recovery planner it
builds (``HeterogeneousPlanner`` for rates): None means ``"cuda"``, and the
manager raises ``RuntimeError`` at construction when no card is visible;
``"cpu"`` runs the sweeps on the host.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..core.order_stats import ServiceDistribution
from ..core.planner import (
    AnalyticPlanner,
    ClusterSpec,
    HeterogeneousPlanner,
    Objective,
    Plan,
    Planner,
)
from ..core.policies import Assignment
from ..core.replication import ReplicationPlan, batch_index_for_data_coord
from ..core.spectrum import Metric
from ..device import resolve_device

__all__ = ["StragglerDetector", "FaultManager", "FaultDecision"]


@dataclasses.dataclass
class StragglerDetector:
    n_workers: int
    window: int = 20
    threshold: float = 3.0  # flag if time > threshold * fleet median
    min_history: int = 5

    def __post_init__(self):
        self._hist: deque[np.ndarray] = deque(maxlen=self.window)

    def observe(self, step_times: np.ndarray) -> None:
        t = np.asarray(step_times, dtype=float)
        if t.shape != (self.n_workers,):
            raise ValueError(f"expected ({self.n_workers},), got {t.shape}")
        self._hist.append(t)

    def drop_mask(self) -> np.ndarray:
        """True = keep.  Workers persistently slower than threshold x median
        get dropped from the NEXT step's aggregation (their replica group
        still covers the batch)."""
        if len(self._hist) < self.min_history:
            return np.ones(self.n_workers, dtype=bool)
        h = np.stack(self._hist)  # (w, n)
        finite = np.where(np.isfinite(h), h, np.nan)
        per_worker = np.nanmedian(finite, axis=0)
        fleet = np.nanmedian(per_worker)
        mask = per_worker <= self.threshold * fleet
        dead = np.isnan(per_worker)
        return mask & ~dead


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    kind: str  # 'ok' | 'mask' | 'replan'
    alive: np.ndarray  # per-worker keep mask
    lost_batches: tuple[int, ...] = ()

    @property
    def needs_restart(self) -> bool:
        return self.kind == "replan"


@dataclasses.dataclass
class FaultManager:
    plan: ReplicationPlan
    heartbeat_misses_fatal: int = 3
    planner: Optional[Planner] = None  # recovery solver (default: analytic)
    # torch device of the default rate-aware planner: None means "cuda"
    device: Optional[str] = None

    def __post_init__(self):
        resolve_device(self.device)
        self._missed = np.zeros(self.plan.n_data, dtype=int)

    def heartbeat(self, responded: np.ndarray) -> None:
        responded = np.asarray(responded, dtype=bool)
        self._missed = np.where(responded, 0, self._missed + 1)

    def mark_dead(self, worker: int) -> None:
        """Declare one worker dead IMMEDIATELY (no miss-count grace).

        The wall-clock cluster runtime has death signals stronger than a
        missed poll — a socket EOF when a worker process is SIGKILLed, or a
        heartbeat gap past the hard timeout — and routes them here so
        :meth:`decide` / :meth:`plan_recovery` see the loss on the next
        step without waiting ``heartbeat_misses_fatal`` polls.
        """
        if not 0 <= worker < self.plan.n_data:
            raise ValueError(
                f"worker {worker} out of range [0, {self.plan.n_data})"
            )
        self._missed[worker] = self.heartbeat_misses_fatal

    def dead_mask(self) -> np.ndarray:
        """True = dead."""
        return self._missed >= self.heartbeat_misses_fatal

    def decide(
        self,
        straggler_keep: Optional[np.ndarray] = None,
        assignment: Optional[Assignment] = None,
    ) -> FaultDecision:
        """Combine hard faults + straggler drops into the step decision.

        ``assignment`` supplies the active worker->batch map (rate-aware
        placements differ from the canonical replica-major layout); without
        it the plan's replica-major coordinate map is used.
        """
        alive = ~self.dead_mask()
        if straggler_keep is not None:
            alive = alive & np.asarray(straggler_keep, dtype=bool)
        if assignment is not None:
            if assignment.n_workers != self.plan.n_data:
                raise ValueError(
                    f"assignment covers {assignment.n_workers} workers but "
                    f"plan has {self.plan.n_data} — stale placement?"
                )
            n_batches = assignment.n_batches
            batch_of = assignment.worker_batch
        else:
            n_batches = self.plan.n_batches
            batch_of = [
                batch_index_for_data_coord(self.plan, w)
                for w in range(self.plan.n_data)
            ]
        # which batches still have at least one live replica?
        covered = np.zeros(n_batches, dtype=bool)
        for w in range(self.plan.n_data):
            if alive[w]:
                covered[batch_of[w]] = True
        lost = tuple(int(b) for b in np.nonzero(~covered)[0])
        if lost:
            return FaultDecision("replan", alive, lost)
        if not alive.all():
            return FaultDecision("mask", alive)
        return FaultDecision("ok", alive)

    def plan_recovery(
        self,
        dist: ServiceDistribution,
        rates: Optional[Sequence[float]] = None,
        batch_divisor: Optional[int] = None,
        metric: Metric = "mean",
    ) -> Plan:
        """Re-plan for the surviving fleet through the unified planner.

        Builds a ClusterSpec of the heartbeat-alive workers (keeping their
        per-worker ``rates`` if known), constrains B to at most the
        pre-fault value (recovery never increases parallelism past what the
        operator chose) and to divide ``batch_divisor`` when given (e.g. the
        global batch size), then delegates to the Planner.
        """
        alive = ~self.dead_mask()
        n_alive = int(alive.sum())
        if n_alive < 1:
            raise RuntimeError("no workers left")
        surviving_rates = None
        if rates is not None:
            r = np.asarray(rates, dtype=float)
            if r.shape != (self.plan.n_data,):
                raise ValueError(
                    f"rates shape {r.shape} != ({self.plan.n_data},)"
                )
            surviving_rates = tuple(float(x) for x in r[alive])
        spec = ClusterSpec(
            n_workers=n_alive,
            dist=dist,
            rates=surviving_rates,
            batch_divisor=batch_divisor,
            max_batches=self.plan.n_batches,
        )
        planner = self.planner
        if planner is None:
            planner = (
                HeterogeneousPlanner(device=self.device)
                if surviving_rates is not None
                else AnalyticPlanner()
            )
        return planner.plan(spec, Objective(metric=metric))
