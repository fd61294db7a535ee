"""Op-level cost walker: FLOPs, HBM bytes and collective wire bytes of
what a function dispatches, one aten op at a time.

The counterpart of ``repro.roofline.hlo_cost``.  The reference walks the
optimized HLO text of a compiled XLA module, where a fusion's inner ops
are free; eager PyTorch launches one kernel an op, and each op reads its
operands from HBM and writes its result there, so the walk is of the ops
themselves.  :func:`walk_ops` runs a function under a
``TorchDispatchMode``, usually on meta tensors (nothing is allocated),
and costs each op as ``hlo_cost`` costs each instruction:

  matmul family  (mm, bmm, addmm, baddbmm, convolution and its backward)
                 FLOPs by ``torch.utils.flop_counter``'s formulas (2 x
                 result elements x contraction, what ``FlopCounterMode``
                 counts); bytes = operands + result
  free           views and metadata (view, permute, expand, slice,
                 split, ...) and allocations (empty): no bytes
  index writes   (index_put_, scatter_, slice_scatter, index_copy_,
                 copy_): 2 x the update's bytes (``dynamic-update-slice``);
                 the functional ``index_put`` (a gather's backward) writes
                 a whole new tensor, so it is an op like any other
  collectives    ring-model wire bytes over the group's k ranks, split
                 into inside a node and across nodes of ``node_size``
                 ranks by the group's global ranks; bytes += 2 x result
  every other op bytes = operands + result; Python scalars are free

An operand's bytes are those its strides address: a broadcast (stride 0)
dim counts once.  A kernel wrapper called on meta tensors records its
kernel's noted work (``_build.note_meta_work``) under the kernel's name.
Eager PyTorch runs every iteration of a loop, so no trip count is
resolved.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "walk_ops", "walking", "top_ops", "rank_ops",
           "group_crosses", "NODE_SIZE"]

# ranks a node: an HGX H100's NVLink domain (the reference's pod_size)
NODE_SIZE = 8

_FREE = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "permute", "transpose",
    "transpose_", "t", "t_", "expand", "unsqueeze", "unsqueeze_", "squeeze",
    "squeeze_", "slice", "select", "as_strided", "as_strided_", "alias",
    "detach", "detach_", "split", "split_with_sizes", "unbind", "chunk",
    "unfold", "diagonal", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "set_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "size", "stride", "numel", "dim",
    "is_contiguous", "is_same_size", "is_strides_like_format",
    "is_non_overlapping_and_dense", "wait_tensor",
})
# name -> the argument that is its update (copy_: the source)
_INDEX_WRITES = {"index_put_": "values", "_index_put_impl_": "values",
                 "scatter_": "src",
                 "slice_scatter": "src", "index_copy_": "source",
                 "copy_": "src"}
# name -> (hlo_cost's collective, the argument its result is)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "alltoall_base_": ("all-to-all", 0),
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "all_gather_into_tensor": ("all-gather", None),
    "all_to_all_single": ("all-to-all", None),
}


@dataclasses.dataclass
class OpCost:
    """The walk's totals; ``by_op`` maps each op (``aten.mm``) or noted
    kernel (``flash_attention``) to its calls, FLOPs and bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_intra: float = 0.0
    coll_inter: float = 0.0
    coll_by_type: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        # integers while the ops' counts are (exact past 2^53)
        row = self.by_op.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes


def group_crosses(ranks, node_size: int = NODE_SIZE):
    """(k, crosses) of a collective's replica groups: ``ranks`` is one
    group's global ranks or a list of groups; k is a group's size, and
    crosses whether any group spans more than one node of ``node_size``
    ranks.  The counterpart of ``hlo_cost._replica_group_info``."""
    if not len(ranks):
        return 1, False
    groups = ([list(g) for g in ranks] if hasattr(ranks[0], "__iter__")
              else [list(ranks)])
    crosses = any(len({r // node_size for r in g}) > 1 for g in groups)
    return len(groups[0]), crosses


def _addressed(t: torch.Tensor) -> int:
    """Bytes a tensor's strides address: broadcast dims count once."""
    if t.is_contiguous():
        return t.numel() * t.element_size()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _bytes(x) -> int:
    return sum(_addressed(t) for t in _tensors(x))


def _classify(func):
    """(kind, name, extra) of an op, computed once an overload."""
    packet = func.overloadpacket
    name = packet.__name__
    key = f"{func.namespace}.{name}"
    if func.namespace in ("c10d", "_c10d_functional") and name in _COLLECTIVES:
        return "collective", key, _COLLECTIVES[name]
    if func.namespace == "prim" or name in _FREE:
        return "free", key, None
    from torch.utils.flop_counter import flop_registry

    if packet in flop_registry:
        return "flops", key, flop_registry[packet]
    if name in _INDEX_WRITES:
        return "index_write", key, _INDEX_WRITES[name]
    return "op", key, None


def _group(func, args, kwargs):
    """The global ranks of a collective's process group."""
    import torch.distributed as dist

    bound = _bound(func, args, kwargs)
    if "process_group" in bound:
        from torch._C._distributed_c10d import ProcessGroup

        pg = bound["process_group"]
        if isinstance(pg, torch.ScriptObject):
            pg = ProcessGroup.unbox(pg)
    else:
        from torch.distributed.distributed_c10d import _resolve_process_group

        pg = _resolve_process_group(bound["group_name"])
    return dist.get_process_group_ranks(pg)


def _bound(func, args, kwargs) -> dict:
    names = [a.name for a in func._schema.arguments]
    return dict(zip(names, args), **kwargs)


_KINDS: dict = {}


class _Walker(TorchDispatchMode):
    def __init__(self, cost: OpCost, node_size: int):
        super().__init__()
        self.cost, self.node_size = cost, node_size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _classify(func)
        what, key, extra = kind
        if what == "free":
            return out
        if what in ("op", "flops"):
            nbytes = _bytes(args) + _bytes(out)
            if kwargs:
                nbytes += _bytes(list(kwargs.values()))
            flops = extra(*args, **kwargs, out_val=out) if what == "flops" \
                else 0
            self.cost.add(key, flops, nbytes)
        elif what == "index_write":
            bound = _bound(func, args, kwargs)
            if extra in bound:
                upd = _bytes(bound[extra])
            else:  # scatter_ of a value: one element an index
                upd = bound["index"].numel() * bound["self"].element_size()
            self.cost.add(key, 0, 2 * upd)
        else:
            self._collective(func, key, extra, args, kwargs, out)
        return out

    def _collective(self, func, key, extra, args, kwargs, out):
        base, res = extra
        rbytes = _bytes(out if res is None else args[res])
        k, crosses = group_crosses(_group(func, args, kwargs), self.node_size)
        ring = (k - 1) / k if k > 1 else 0.0
        if base == "all-reduce":
            wire = 2.0 * rbytes * ring
        elif base == "reduce-scatter":
            wire = rbytes * (k - 1)
        else:
            wire = rbytes * ring
        c = self.cost
        c.coll_by_type[base] = c.coll_by_type.get(base, 0.0) + wire
        c.n_collectives += 1
        if crosses:
            c.coll_inter += wire
        else:
            c.coll_intra += wire
        c.add(key, 0, 2 * rbytes)


@contextlib.contextmanager
def walking(node_size: int = NODE_SIZE):
    """Yields an :class:`OpCost` that every op dispatched in the block
    fills, the kernels' noted work added when the block ends."""
    from ..kernels import _build

    cost = OpCost()
    with _build.record_meta_work() as work, _Walker(cost, node_size):
        yield cost
    for name, flops, nbytes in work:
        cost.add(name, flops, nbytes)


def walk_ops(fn, *args, node_size: int = NODE_SIZE, **kwargs) -> OpCost:
    """The cost of ``fn(*args, **kwargs)``, op by op.  The counterpart of
    ``hlo_cost.walk_hlo``."""
    with walking(node_size) as cost:
        fn(*args, **kwargs)
    return cost


def rank_ops(by_op: dict, key: str = "bytes", k: int = 15) -> list:
    """The ``k`` entries of a ``by_op`` table largest in ``key``:
    [(value, op, calls), ...]."""
    rows = sorted(by_op.items(), key=lambda kv: -kv[1][key])[:k]
    return [(row[key], name, row["calls"]) for name, row in rows]


def top_ops(fn, *args, k: int = 15, node_size: int = NODE_SIZE, **kwargs):
    """Debug view of ``fn``'s walk: the ``k`` ops largest in FLOPs, in
    bytes, and the collectives by wire bytes.  The counterpart of
    ``hlo_cost.top_instructions``."""
    cost = walk_ops(fn, *args, node_size=node_size, **kwargs)
    colls = sorted(((w, t) for t, w in cost.coll_by_type.items()),
                   reverse=True)[:k]
    return (rank_ops(cost.by_op, "flops", k), rank_ops(cost.by_op, "bytes", k),
            colls)
