"""Replication-aware collectives + byte accounting, on ``torch.distributed``.

Members of a replica group hold IDENTICAL gradients, so

* ``replication_aware_pmean``  -- averages over the ``batch`` group only;
  the ``replica`` group (mapped onto hosts) carries no gradient traffic in
  the steady state;
* ``hierarchical_allreduce``   -- the same mean as a reduce-scatter then an
  all-gather over the batch group, the two phases explicit;
* :func:`allreduce_bytes` -- analytic per-rank byte model used by the
  benchmarks.

``group`` is the batch process group, e.g. ``mesh.get_group("batch")`` of
:func:`repro_torch.core.replication.make_rdp_mesh`.  Inputs are trees of
tensors (nested dicts, lists, tuples) and are not modified.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.replication import ReplicationPlan
from ..tree import tree_map

__all__ = [
    "replication_aware_pmean",
    "hierarchical_allreduce",
    "allreduce_bytes",
]


def replication_aware_pmean(tree, group):
    """Steady-state RDP gradient mean: one average all_reduce over the
    batch group."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def mean(g):
        out = g.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / n

    return tree_map(mean, tree)


def hierarchical_allreduce(tree, group):
    """reduce_scatter(batch) -> all_gather(batch): the same result as
    :func:`replication_aware_pmean`, with the two phases exposed; the
    replica group stays idle."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def rs_ag(g):
        flat = g.reshape(-1)
        # pad to a multiple of the batch group's size
        flat = F.pad(flat, (0, (-flat.numel()) % n))
        piece = torch.empty(flat.numel() // n, dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(piece, flat, op=dist.ReduceOp.SUM,
                                   group=group)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, piece, group=group)
        return full[: g.numel()].reshape(g.shape) / n

    return tree_map(rs_ag, tree)


def allreduce_bytes(
    n_bytes: int, plan: ReplicationPlan, mode: str = "rdp"
) -> dict[str, float]:
    """Analytic per-rank collective bytes for a gradient of ``n_bytes``.

    Ring all-reduce over k ranks moves 2 * (k-1)/k * n_bytes per rank.
    Returns bytes split into intra-group (fast, e.g. NVLink within a host)
    and cross-replica (slow, e.g. between hosts) assuming ``replica`` maps
    onto the slow tier.

    modes: 'plain' (all-reduce over all N_d), 'rdp' (batch group only),
           'weighted' (rdp + small replica-group mask reconcile).
    """
    n = plan.n_data
    b = plan.n_batches
    r = plan.replication
    ring = lambda k: 0.0 if k <= 1 else 2.0 * (k - 1) / k * n_bytes
    if mode == "plain":
        # ring over all n workers; the slow tier carries ~1/r of the ring hops
        total = ring(n)
        cross = total * (r - 1) / max(n - 1, 1)
        return {"intra": total - cross, "cross": cross, "total": total}
    if mode == "rdp":
        return {"intra": ring(b), "cross": 0.0, "total": ring(b)}
    if mode == "weighted":
        # mask-weighted reconcile: one extra all-reduce over replica of the
        # already-reduced mean -- only when masks differ; upper bound here
        cross = ring(r)
        return {"intra": ring(b), "cross": cross, "total": ring(b) + cross}
    raise ValueError(f"unknown mode {mode}")
