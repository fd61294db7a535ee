"""Rank bodies of the port's multi-process ``torch.distributed`` tests.

Each rank is a process of its own, started as

    python tests/_torch_dist_ranks.py RANK WORLD STORE OUT

with ``src`` on ``PYTHONPATH``.  It joins a gloo group through the file
store ``STORE``, runs the RDP cases of ``tests/test_torch_replication.py``
(the reference's 8-device ``shard_map`` script, r = 2, B = 4) on the port's
``make_rdp_mesh``, ``aggregate_gradients`` and collectives, records the
ranks of every group a collective ran on, and saves its results to
``OUT/rank{RANK}.pt``.  It imports torch and ``repro_torch`` only.
"""

import sys

import torch
import torch.distributed as dist


def _record(calls):
    """Wrap the collectives so each call appends (name, group ranks)."""
    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        orig = getattr(dist, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            group = kw.get("group")
            ranks = (tuple(range(dist.get_world_size())) if group is None
                     else tuple(dist.get_process_group_ranks(group)))
            calls.append((_name, ranks))
            return _orig(*args, **kw)

        setattr(dist, name, wrapped)


def main(rank, world, store, out):
    from repro_torch.core.replication import (ReplicationPlan,
                                              aggregate_gradients,
                                              make_rdp_mesh)
    from repro_torch.distributed.collectives import (hierarchical_allreduce,
                                                     replication_aware_pmean)

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        plan = ReplicationPlan(n_data=8, n_batches=4)
        mesh = make_rdp_mesh(plan, model_parallel=1, device_type="cpu")
        batch = mesh.get_group("batch")
        calls = []
        _record(calls)
        res = {"mesh": mesh.mesh.tolist(),
               "coord": [int(c) for c in mesh.get_coordinate()]}
        # the reference script's inputs: g = arange(8) % 4, ranks 2 and 6
        # (both replicas of batch 2) dead
        g = torch.tensor([float(rank % 4)])
        alive = 0.0 if rank in (2, 6) else 1.0
        out_w, nb = aggregate_gradients({"w": g}, alive, "weighted",
                                        mesh=mesh)
        res["weighted"], res["n_batches_used"] = out_w["w"], nb
        # distinct replica values, one replica of batch 0 dead, a tree
        tree = {"w": torch.arange(6.0).reshape(2, 3) * (rank + 1),
                "b": [torch.tensor([rank * 0.5 - 1.0]),
                      torch.full((2,), rank ** 0.5)]}
        out_d, nb_d = aggregate_gradients(tree, 0.0 if rank == 0 else 1.0,
                                          "weighted", mesh=mesh)
        res["weighted_tree"], res["n_batches_used_tree"] = out_d, nb_d
        n0 = len(calls)
        res["psum_all"], _ = aggregate_gradients(tree, mode="psum_all",
                                                 mesh=mesh)
        res["psum_all_groups"] = calls[n0:]
        # the steady-state paths: the script's (3, 1) tile of g
        steady = {"w": g.reshape(1, -1) * torch.ones((3, 1))}
        n0 = len(calls)
        res["hierarchical_mode"], _ = aggregate_gradients(
            steady, mode="hierarchical", mesh=mesh)
        res["pmean"] = replication_aware_pmean(steady, batch)
        res["hier"] = hierarchical_allreduce(steady, batch)
        # an odd length pads to the group size
        res["hier_tree"] = hierarchical_allreduce(tree, batch)
        res["pmean_tree"] = replication_aware_pmean(tree, batch)
        res["steady_groups"] = calls[n0:]
        res["inputs_unchanged"] = bool(
            torch.equal(g, torch.tensor([float(rank % 4)]))
            and torch.equal(tree["w"], torch.arange(6.0).reshape(2, 3)
                            * (rank + 1)))
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
