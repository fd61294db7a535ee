"""Replicated data parallelism (RDP): the paper's technique as a mesh and
collective feature, on ``torch.distributed``.

The data-parallel extent ``N_d`` of the mesh is factored into
``(replica=r, batch=B)`` with ``B * r = N_d``:

* all ``r`` ranks of a *replica group* (fixed batch index) receive the SAME
  microbatch: the balanced non-overlapping assignment of Thm 1;
* the gradient is the mean over the B distinct batches; a batch survives as
  long as ANY of its replicas survives: the paper's ``max-min`` rule;
* replicas are placed OUTERMOST (ranks replica-major), so on a multi-host
  mesh the replica axis strides across hosts: replicas of a batch live on
  different hosts, and the steady state moves no gradient between them
  (identical replicas need no reduction).

Aggregation modes (:func:`aggregate_gradients`, one ``all_reduce`` a step
on the mesh's ``replica`` or ``batch`` process group):

* ``psum_all``     -- baseline: mean over the full (replica, batch) plane.
* ``weighted``     -- straggler-drop weighted mean: dead or dropped ranks are
                      masked; per-batch renormalization keeps the estimate an
                      exact mean over surviving batches.
* ``hierarchical`` -- steady-state fast path: mean over ``batch`` only
                      (replicas already agree); no replica-group traffic.

:func:`aggregate_host` is the host-side reference of ``weighted`` on
nested dicts and lists of numpy arrays or tensors.

``torch.distributed`` is imported inside the functions that use it, so
importing this module opens nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map, tree_unflatten
from .order_stats import ServiceDistribution, completion_mean, completion_var
from .policies import divisors

__all__ = [
    "ReplicationPlan",
    "make_rdp_mesh",
    "batch_index_for_data_coord",
    "aggregate_gradients",
    "aggregate_host",
    "rdp_data_spec",
]

AggregationMode = Literal["psum_all", "weighted", "hierarchical"]

REPLICA_AXIS = "replica"
BATCH_AXIS = "batch"
MODEL_AXIS = "model"


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


def make_rdp_mesh(plan: ReplicationPlan, model_parallel: int,
                  device_type=None):
    """The ``DeviceMesh`` of shape ``(r, B, model)`` over the default
    process group, dims named ``("replica", "batch", "model")``.

    Ranks are taken replica-major (rank = (replica * B + batch) * model +
    m), as the reference reshapes its device list, so with r replicas the
    replica dim strides across the largest blocks of ranks.
    ``device_type=None`` means ``"cuda"`` and raises without a card;
    ``"cpu"`` builds the mesh over gloo.  The world size must equal
    ``plan.n_data * model_parallel``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    expected = plan.n_data * model_parallel
    world = dist.get_world_size()
    if world != expected:
        raise ValueError(
            f"need {expected} ranks for plan {plan} x model={model_parallel}, "
            f"got {world}"
        )
    return init_device_mesh(
        dev.type,
        (plan.replication, plan.n_batches, model_parallel),
        mesh_dim_names=(REPLICA_AXIS, BATCH_AXIS, MODEL_AXIS),
    )


def rdp_data_spec(*trailing) -> tuple:
    """DTensor placements of an activation under RDP, one per mesh dim
    ``(replica, batch, model)``: dim 0 is sharded over ``batch`` and
    REPLICATED over ``replica`` -- the assignment unit: every member of a
    replica group sees the same data.  ``trailing`` names, for each later
    tensor dim, ``"model"`` (sharded over it) or ``None``."""
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:  # torch before 2.5 keeps them private
        from torch.distributed._tensor import Replicate, Shard

    placements = {REPLICA_AXIS: Replicate(), BATCH_AXIS: Shard(0),
                  MODEL_AXIS: Replicate()}
    for tdim, axis in enumerate(trailing, start=1):
        if axis is None:
            continue
        if axis != MODEL_AXIS:
            raise ValueError(
                f"tensor dim {tdim} may be sharded over {MODEL_AXIS!r} only, "
                f"got {axis!r}"
            )
        placements[MODEL_AXIS] = Shard(tdim)
    return tuple(placements[a] for a in (REPLICA_AXIS, BATCH_AXIS, MODEL_AXIS))


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def aggregate_gradients(grads, alive=None, mode: AggregationMode = "weighted",
                        *, mesh):
    """Aggregate this rank's gradients over an RDP ``mesh``.

    ``grads`` is a dict or list (nested) of local gradient tensors (each
    replica group member computed the same batch).  ``alive`` is this
    rank's 0/1 contribution flag (default 1).  Every step is an
    ``all_reduce`` on ``mesh.get_group("replica")`` or
    ``mesh.get_group("batch")``; the inputs are not modified.

    Returns ``(aggregated, n_batches_used)``: the same tree on every rank,
    equal to the exact mean over surviving batches, and (``weighted``
    only, else None) the 0-d float32 count of surviving batches.  If a
    whole replica group died its batch is excluded and the mean
    renormalizes.
    """
    if mode == "psum_all":
        n = mesh.size(0) * mesh.size(1)
        replica, batch = mesh.get_group(REPLICA_AXIS), mesh.get_group(BATCH_AXIS)
        return tree_map(
            lambda g: _all_reduce_sum(_all_reduce_sum(g, replica), batch) / n,
            grads,
        ), None
    if mode == "hierarchical":
        batch, n = mesh.get_group(BATCH_AXIS), mesh.size(1)
        return tree_map(lambda g: _all_reduce_sum(g, batch) / n, grads), None
    if mode != "weighted":
        raise ValueError(f"unknown aggregation mode {mode!r}")

    replica, batch = mesh.get_group(REPLICA_AXIS), mesh.get_group(BATCH_AXIS)
    dev = tree_leaves(grads)[0].device
    alive = torch.as_tensor(1.0 if alive is None else alive,
                            dtype=torch.float32, device=dev)
    # per replica group: how many members contributed
    n_alive_in_group = _all_reduce_sum(alive, replica)
    group_ok = (n_alive_in_group > 0).to(torch.float32)
    # weight for this rank inside its group (0 if the group is empty)
    w_member = torch.where(n_alive_in_group > 0,
                           alive / torch.clamp(n_alive_in_group, min=1.0),
                           torch.zeros_like(alive))
    # number of surviving batches (same value on every rank)
    n_batches_used = _all_reduce_sum(group_ok, batch)

    def agg(g):
        g = g.to(torch.float32) if g.is_floating_point() else g
        # mean within the replica group (survivors only)
        g_group = _all_reduce_sum(g * w_member, replica)
        # mean over surviving batches
        g_sum = _all_reduce_sum(g_group, batch)
        return g_sum / torch.clamp(n_batches_used, min=1.0)

    return tree_map(agg, grads), n_batches_used


def aggregate_host(
    grads_per_worker: list,
    alive: np.ndarray,
    plan: ReplicationPlan,
    worker_batch=None,
):
    """Host-side (coordinator-level) reference aggregation: nested dicts and
    lists of numpy arrays or tensors, the semantics of
    :func:`aggregate_gradients` with mode='weighted'.

    ``grads_per_worker[w]`` is the gradient tree computed by flat data
    coordinate ``w`` (or None if it produced nothing); ``alive[w]`` marks
    contribution.  ``worker_batch`` optionally supplies the active
    worker->batch map (rate-aware placements differ from the replica-major
    coordinate map used by default).  Returns (mean over surviving batches,
    n_batches_used).  The sums are left folds divided by the member count,
    in the reference's order, so the result equals the reference's bit for
    bit.
    """
    if len(grads_per_worker) != plan.n_data:
        raise ValueError("need one (possibly None) gradient per data coord")
    if worker_batch is None:
        worker_batch = [
            batch_index_for_data_coord(plan, w) for w in range(plan.n_data)
        ]
    elif len(worker_batch) != plan.n_data:
        raise ValueError("worker_batch must map every data coord")
    alive = np.asarray(alive, dtype=bool)
    batch_grads = []
    for b in range(plan.n_batches):
        members = [
            w
            for w in range(plan.n_data)
            if worker_batch[w] == b and alive[w]
            and grads_per_worker[w] is not None
        ]
        if not members:
            continue
        if len(members) == 1:
            # x / 1 == x exactly: keep the member's own tree rather than a
            # copy (the trainer sends one member a batch, and a copy a
            # batch would double the step's gradient memory)
            batch_grads.append(grads_per_worker[members[0]])
            continue
        # replicas agree; average anyway for numerical symmetry
        leaves = [tree_leaves(grads_per_worker[w]) for w in members]
        mean_leaves = [
            functools.reduce(lambda a, c: a + c, parts) / len(members)
            for parts in zip(*leaves)
        ]
        batch_grads.append(
            tree_unflatten(grads_per_worker[members[0]], mean_leaves))
    if not batch_grads:
        raise RuntimeError("all batches lost — elastic re-plan required")
    leaves = [tree_leaves(g) for g in batch_grads]
    mean_leaves = [
        functools.reduce(lambda a, c: a + c, parts) / len(batch_grads)
        for parts in zip(*leaves)
    ]
    return tree_unflatten(batch_grads[0], mean_leaves), len(batch_grads)
