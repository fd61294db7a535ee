"""Elastic rescaling: apply a RescalePlan (tuner), a recovery Plan (fault
manager), or a shrink event to produce the next runtime configuration.

The state that survives a rescale is exactly (params, opt_state, data step)
— all placement-agnostic — so the executor's job is bookkeeping: pick the
new (N', B'), validate divisibility, and describe the new mesh factoring.
All B decisions are delegated to the unified
:class:`~repro_torch.core.planner.Planner` control plane; in particular
:meth:`RescaleExecutor.shrink` on a skewed fleet drops the n_lost SLOWEST
workers (via ``ClusterSpec.drop_slowest``) and re-plans from the surviving
rates — not arbitrary ids.

``RescaleExecutor.device`` is the torch device of the planners it builds
(``HeterogeneousPlanner`` for rates): None means ``"cuda"``, and the
executor raises ``RuntimeError`` at construction when no card is visible;
``"cpu"`` runs the sweeps on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core.order_stats import ServiceDistribution
from ..core.planner import (
    AnalyticPlanner,
    ClusterSpec,
    HeterogeneousPlanner,
    Objective,
    Plan,
    Planner,
)
from ..core.policies import Assignment, divisors
from ..core.replication import ReplicationPlan
from ..core.spectrum import Metric
from ..device import resolve_device

__all__ = ["RescaleExecutor", "RuntimeTopology"]


@dataclasses.dataclass(frozen=True)
class RuntimeTopology:
    plan: ReplicationPlan
    generation: int  # bumped on every rescale (invalidates compiled steps)
    assignment: Optional[Assignment] = None  # planner placement, if any
    dropped_workers: tuple[int, ...] = ()  # ids shed by the last shrink

    @property
    def n_workers(self) -> int:
        return self.plan.n_data


@dataclasses.dataclass
class RescaleExecutor:
    topology: RuntimeTopology
    planner: Optional[Planner] = None  # default: analytic / rate-aware
    # torch device of the default rate-aware planner: None means "cuda"
    device: Optional[str] = None

    def __post_init__(self):
        resolve_device(self.device)

    def _planner_for(self, spec: ClusterSpec) -> Planner:
        if self.planner is not None:
            return self.planner
        if spec.rates is not None:
            return HeterogeneousPlanner(device=self.device)
        return AnalyticPlanner()

    def apply_replan(self, new_batches: int) -> RuntimeTopology:
        plan = ReplicationPlan(
            n_data=self.topology.plan.n_data, n_batches=new_batches
        )
        self.topology = RuntimeTopology(plan, self.topology.generation + 1)
        return self.topology

    def apply_plan(self, plan: Plan) -> RuntimeTopology:
        """Adopt a full planner decision (factoring + placement)."""
        self.topology = RuntimeTopology(
            plan.replication,
            self.topology.generation + 1,
            assignment=plan.assignment,
        )
        return self.topology

    def shrink(
        self,
        n_lost: int,
        dist: Optional[ServiceDistribution] = None,
        rates: Optional[Sequence[float]] = None,
        metric: Metric = "mean",
        batch_divisor: Optional[int] = None,
    ) -> RuntimeTopology:
        """Lose ``n_lost`` workers and re-plan B for the survivors.

        * ``dist`` + ``rates``: the n_lost SLOWEST workers are shed and the
          planner re-plans from the surviving rates (rate-aware placement);
          the dropped ids are recorded on the topology.
        * ``dist`` only: homogeneous re-plan through the planner.
        * neither: no service model available — keep the largest feasible
          B <= the old B (pure bookkeeping fallback).

        ``batch_divisor`` carries the caller's data-sharding constraint
        (e.g. the global batch size) into the survivors' ClusterSpec.
        """
        old = self.topology.plan
        n_new = old.n_data - n_lost
        if n_new < 1:
            raise RuntimeError("no workers left")
        if dist is None:
            if rates is not None:
                raise ValueError("rates require a service distribution (dist)")
            b_new = max(
                b for b in divisors(n_new)
                if b <= old.n_batches
                and (batch_divisor is None or batch_divisor % b == 0)
            )
            self.topology = RuntimeTopology(
                ReplicationPlan(n_data=n_new, n_batches=b_new),
                self.topology.generation + 1,
            )
            return self.topology
        spec = ClusterSpec(
            n_workers=old.n_data,
            dist=dist,
            rates=tuple(float(r) for r in rates) if rates is not None else None,
            batch_divisor=batch_divisor,
            # shrinking never increases parallelism past the operator's
            # pre-shrink choice (same policy as FaultManager.plan_recovery
            # and the no-model fallback above)
            max_batches=old.n_batches,
        )
        spec, dropped = spec.drop_slowest(n_lost)
        plan = self._planner_for(spec).plan(spec, Objective(metric=metric))
        self.topology = RuntimeTopology(
            plan.replication,
            self.topology.generation + 1,
            assignment=plan.assignment,
            dropped_workers=dropped,
        )
        return self.topology
