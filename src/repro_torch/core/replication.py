"""The (batch, replica) factoring the planner emits.

The port carries the :class:`ReplicationPlan` dataclass and the
replica-major feed map :func:`batch_index_for_data_coord`.  The mesh and
gradient-aggregation half of ``repro.core.replication`` is not ported yet.
"""

from __future__ import annotations

import dataclasses

from .order_stats import ServiceDistribution, completion_mean, completion_var
from .policies import divisors

__all__ = ["ReplicationPlan", "batch_index_for_data_coord"]


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    """Factoring of the data-parallel extent into (batch, replica)."""

    n_data: int  # total data-parallel device extent (incl. pod axis)
    n_batches: int  # B

    def __post_init__(self):
        if self.n_data <= 0 or self.n_batches <= 0:
            raise ValueError(f"invalid plan {self}")
        if self.n_data % self.n_batches:
            raise ValueError(
                f"B={self.n_batches} must divide data extent {self.n_data}"
            )

    @property
    def replication(self) -> int:
        return self.n_data // self.n_batches

    @property
    def is_full_parallelism(self) -> bool:
        return self.n_batches == self.n_data

    @property
    def is_full_diversity(self) -> bool:
        return self.n_batches == 1

    def feasible_alternatives(self) -> list[int]:
        return divisors(self.n_data)

    def expected_step_stats(
        self, dist: ServiceDistribution
    ) -> tuple[float, float]:
        """(mean, var) of the per-step completion time under the paper's
        model, treating the B batches as the paper's batches and r as the
        replication (Thms 2-4)."""
        return (
            completion_mean(dist, self.n_data, self.n_batches),
            completion_var(dist, self.n_data, self.n_batches),
        )


def batch_index_for_data_coord(plan: ReplicationPlan, data_coord: int) -> int:
    """Which batch a flat data-axis coordinate serves (pipeline feed map).

    Flat data coordinates enumerate (replica-major) the (replica, batch)
    grid: coord = replica * B + batch.
    """
    if not 0 <= data_coord < plan.n_data:
        raise ValueError(f"data coord {data_coord} out of range")
    return data_coord % plan.n_batches
