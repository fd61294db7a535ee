"""Production mesh shapes, as ordered ``{axis: size}`` mappings.

The reference builds ``jax.sharding.Mesh`` objects over a TPU pod (16 x
16, 256 chips) or two (2 x 16 x 16).  The port keeps what its decisions
read of a mesh, its axis names and sizes in order: ``auto_policy``, the
placement trees and the dry-run take these shapes, and allocate nothing.
A real ``DeviceMesh`` over live ranks comes from
``repro_torch.core.replication.make_rdp_mesh``.
"""

from __future__ import annotations

from ..core.replication import (BATCH_AXIS, MODEL_AXIS, REPLICA_AXIS,
                                ReplicationPlan)

__all__ = ["production_mesh_shape", "rdp_production_mesh_shape",
           "dp_axes_of", "mesh_size"]

MODEL_PARALLEL = 16
DP_AXIS_NAMES = ("pod", "data", "batch", "replica")


def production_mesh_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """{"data": 16, "model": 16} (one pod, 256 chips), or {"pod": 2,
    "data": 16, "model": 16} (two pods, 512)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": MODEL_PARALLEL}
    return {"data": 16, "model": MODEL_PARALLEL}


def dp_axes_of(shape) -> tuple[str, ...]:
    """The data-parallel axes of a mesh shape, in its order ('pod'
    extends data)."""
    return tuple(a for a in shape if a in DP_AXIS_NAMES)


def mesh_size(shape) -> int:
    """Devices of a mesh shape."""
    n = 1
    for size in shape.values():
        n *= size
    return n


def rdp_production_mesh_shape(n_batches: int, *, multi_pod: bool = False):
    """The production mesh with its data extent factored per the paper:
    ({"replica": r, "batch": B, "model": 16}, plan), the data extent 16
    (one pod) or 32 (two), r = extent / B.  Replica is the outer axis, so
    it strides across pods."""
    plan = ReplicationPlan(n_data=32 if multi_pod else 16,
                           n_batches=n_batches)
    return ({REPLICA_AXIS: plan.replication, BATCH_AXIS: plan.n_batches,
             MODEL_AXIS: MODEL_PARALLEL}, plan)
