"""The port's op-level cost walker (``roofline.op_cost``) against the
reference's HLO walker (``roofline.hlo_cost``).

* ``tests/test_roofline.py``'s three walker cases (a scan of 12 matmuls,
  nested scans of 3 x 5, ``x @ x + 1.0``), jitted on the CPU and walked by
  ``walk_hlo``, and the same programs in eager PyTorch on meta tensors
  walked by ``walk_ops``: FLOPs equal, exactly.
* Bytes: a lone 1024^2 float32 ``x @ y`` and ``x @ x + 1.0`` equal
  ``walk_hlo``'s (12,582,912 and 20,971,520), exactly; the same walks on
  CPU tensors give the same counts.
* ``group_crosses`` against ``_replica_group_info`` on the reference
  test's replica groups (its iota groups written as rank lists).
* Views are free; index writes cost twice their update; a broadcast
  operand counts its addressed bytes; a kernel wrapper's meta call carries
  its ``*_work`` numbers under the kernel's name; ``top_ops`` ranks.

The RDP collectives walked on eight gloo ranks are held to
``allreduce_bytes`` in ``tests/test_torch_replication.py``, beside the
ranks it already spawns.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.roofline.hlo_cost import _replica_group_info, walk_hlo
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_work)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_work)
from repro_torch.roofline.op_cost import (NODE_SIZE, OpCost, group_crosses,
                                          rank_ops, top_ops, walk_ops)

META = torch.device("meta")


def _hlo(fn, *shapes):
    return walk_hlo(jax.jit(fn).lower(*shapes).compile().as_text())


def _scan_ref(x, ys):
    def body(h, y):
        return h @ y, None

    return jax.lax.scan(body, x, ys)[0]


def _nested_ref(x, ys):
    def outer(h, grp):
        def inner(h2, y):
            return h2 @ y, None

        return jax.lax.scan(inner, h, grp)[0], None

    return jax.lax.scan(outer, x, ys)[0]


def _scan_port(x, ys):
    for y in ys:
        x = x @ y
    return x


def _nested_port(x, ys):
    for grp in ys:
        for y in grp:
            x = x @ y
    return x


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _meta(*shape):
    return torch.empty(shape, device=META)


@pytest.mark.parametrize("case", ["scan", "nested_scans", "matmul_add"])
def test_walk_ops_flops_equal_walk_hlo(case):
    if case == "scan":
        ref = _hlo(_scan_ref, _f32(256, 256), _f32(12, 256, 256))
        port = walk_ops(_scan_port, _meta(256, 256), _meta(12, 256, 256))
        assert port.by_op["aten.mm"]["calls"] == 12
    elif case == "nested_scans":
        ref = _hlo(_nested_ref, _f32(128, 128), _f32(3, 5, 128, 128))
        port = walk_ops(_nested_port, _meta(128, 128), _meta(3, 5, 128, 128))
        assert port.by_op["aten.mm"]["calls"] == 15
    else:
        ref = _hlo(lambda x: x @ x + 1.0, _f32(1024, 1024))
        port = walk_ops(lambda x: x @ x + 1.0, _meta(1024, 1024))
    assert port.flops == ref.flops


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_walk_ops_bytes_equal_walk_hlo(device):
    shape = (1024, 1024)
    x = torch.zeros(shape, device=device)
    y = torch.zeros(shape, device=device)
    ref = _hlo(lambda a, b: a @ b, _f32(*shape), _f32(*shape))
    port = walk_ops(lambda a, b: a @ b, x, y)
    assert ref.bytes == 12_582_912 and port.bytes == ref.bytes
    ref = _hlo(lambda a: a @ a + 1.0, _f32(*shape))
    port = walk_ops(lambda a: a @ a + 1.0, x)
    assert ref.bytes == 20_971_520 and port.bytes == ref.bytes
    # the mm (two operands, the result) and the add (one operand, the
    # result; the scalar free)
    assert port.by_op == {
        "aten.mm": {"calls": 1, "flops": 2 * 1024 ** 3, "bytes": 12_582_912},
        "aten.add": {"calls": 1, "flops": 0, "bytes": 8_388_608}}


# (hlo_cost's replica_groups text, the same groups as rank lists, pod size)
_IOTA = np.arange(512)
GROUP_CASES = [
    ("x replica_groups=[32,16]<=[512] y", _IOTA.reshape(32, 16).tolist(),
     256),
    ("x replica_groups=[16,32]<=[32,16]T(1,0) y",
     _IOTA.reshape(32, 16).T.reshape(16, 32).tolist(), 256),
    ("all-reduce(...), replica_groups={{0,1,2,3},{4,5,6,7}}",
     [[0, 1, 2, 3], [4, 5, 6, 7]], 256),
    ("all-reduce(...), replica_groups={{0,256},{1,257}}",
     [[0, 256], [1, 257]], 256),
    ("all-reduce(...), replica_groups={{0,1,2,3},{4,5,6,7}}",
     [[0, 1, 2, 3], [4, 5, 6, 7]], 2),
]


@pytest.mark.parametrize("text,groups,pod", GROUP_CASES)
def test_group_crosses_equals_replica_group_info(text, groups, pod):
    assert group_crosses(groups, pod) == _replica_group_info(text, pod)
    # one group's ranks alone (explicit groups: the reference reads the
    # first)
    if "{{" in text:
        assert group_crosses(groups[0], pod) == _replica_group_info(text, pod)


def test_group_crosses_of_an_hgx_node():
    assert NODE_SIZE == 8
    assert group_crosses(range(8)) == (8, False)
    assert group_crosses([4, 5, 6, 7, 8]) == (5, True)
    assert group_crosses([]) == (1, False)


def test_views_are_free():
    x = _meta(4, 6, 8)

    def views(t):
        a = t.view(24, 8).t().unsqueeze(0).expand(3, 8, 24)
        b = t.permute(2, 0, 1).transpose(0, 1)[1:3, :, 2]
        parts = [*t.split(2, dim=0), *t.unbind(1), *t.chunk(4, dim=2)]
        return a, b, t.squeeze(), t.as_strided((4,), (1,)), t.detach(), parts

    cost = walk_ops(views, x)
    assert cost.bytes == 0 and cost.flops == 0 and cost.by_op == {}


def test_index_writes_cost_twice_their_update():
    x = _meta(64, 32)
    upd = _meta(8, 32)
    idx = torch.zeros(8, dtype=torch.long, device=META)
    cases = {
        "aten.index_put_": lambda: x.index_put_((idx,), upd,
                                                accumulate=True),
        "aten.copy_": lambda: x[8:16].copy_(upd),
        "aten.slice_scatter": lambda: torch.slice_scatter(x, upd, 0, 0, 8),
        "aten.index_copy_": lambda: x.index_copy_(0, idx, upd),
        "aten.scatter_": lambda: x.scatter_(0, idx[:, None].expand(8, 32),
                                            upd),
    }
    for name, fn in cases.items():
        cost = walk_ops(fn)
        assert cost.by_op == {name: {"calls": 1, "flops": 0,
                                     "bytes": 2 * 8 * 32 * 4}}, name


def test_a_broadcast_operand_counts_its_addressed_bytes():
    x, b = _meta(64, 32), _meta(32)
    cost = walk_ops(lambda: x * b.expand(64, 32))
    # x and the (64, 32) result in full, the bias once
    assert cost.bytes == 2 * 64 * 32 * 4 + 32 * 4


def test_a_wrappers_meta_call_carries_its_kernels_work():
    q = torch.empty((2, 48, 4, 64), dtype=torch.bfloat16, device=META)
    k = torch.empty((2, 48, 2, 64), dtype=torch.bfloat16, device=META)
    qd = torch.empty((2, 4, 64), dtype=torch.bfloat16, device=META)
    kc = torch.empty((2, 64, 2, 64), dtype=torch.bfloat16, device=META)
    _build.reset_launch_counts()
    cost = walk_ops(lambda: (flash_attention(q, k, k, causal=True),
                             decode_attention(qd, kc, kc, 40)))
    fw, fb = flash_attention_work(2, 48, 48, 4, 2, 64, True)
    dw, db = decode_attention_work(2, 4, 2, 64, 40)
    # the outputs' allocations are free: the kernels' work is all
    assert cost.by_op == {
        "flash_attention": {"calls": 1, "flops": fw, "bytes": fb},
        "decode_attention": {"calls": 1, "flops": dw, "bytes": db}}
    assert cost.flops == fw + dw and cost.bytes == fb + db
    assert set(_build.launch_counts().values()) == {0}


def test_top_ops_ranks_by_flops_and_bytes():
    x, w = _meta(256, 512), _meta(512, 1024)
    by_flops, by_bytes, colls = top_ops(
        lambda: torch.relu(x @ w).sum(), k=2)
    assert by_flops[0] == (2.0 * 256 * 512 * 1024, "aten.mm", 1)
    assert [name for _, name, _ in by_bytes] == ["aten.mm", "aten.relu"]
    assert by_bytes[1][0] == 2 * 256 * 1024 * 4 and colls == []
    cost = OpCost()
    cost.add("a", 1, 5)
    cost.add("b", 3, 2)
    cost.add("a", 1, 5)
    assert rank_ops(cost.by_op, "bytes", 1) == [(10, "a", 2)]
    assert rank_ops(cost.by_op, "flops") == [(3, "b", 1), (2, "a", 2)]
