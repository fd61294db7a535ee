"""The port's sharding layer against the reference's, on the CPU.

* ``auto_policy`` and ``cell_supported``: every config x every
  ``SHAPE_CELLS`` cell x the production mesh shapes 16 x 16 and 2 x 16 x
  16 and the RDP shapes (replica, batch, model) at B in {2, 4, 8}, one pod
  and two, equal field by field to the reference's on a fake mesh (as
  ``tests/test_sharding_equivalence.py`` builds one), whose
  ``test_auto_policy_expectations`` values are pinned here too.
* The placement trees, ``param_specs``, ``decode_state_specs`` (both
  ``batch_shardable`` values) and ``optim.state_specs``, for every config
  under the policy of each supported cell on each mesh shape: equal leaf
  by leaf to the reference's ``PartitionSpec`` trees as tuples.  Where the
  reference stacks blocks on leading dims (``P(None, *spec)``, one
  ``None`` a stacking level), the port's tree has a list a level, each
  entry the block's own spec: the test strips one leading ``None`` a list
  level and requires it to be ``None``.  Each port spec has one entry a
  dim of the port's meta parameter tree, in its layout.  A one-name
  tuple entry reads as the name, as ``PartitionSpec`` normalises it.
* ``Shard``'s hooks give the placements the reference's apply, recorded
  by patching ``Shard._c`` on the reference's class in the test (the
  reference is not edited); ``mm_boundary``'s forward and cotangent
  placements through ``jax.vjp``; the identity where the reference's is.
* The mesh shapes, ``dp_axes_of`` and ``launch.specs.input_specs``'s
  placements against the reference's, and the per-device bytes of a tree.

The reference's ``count_params`` (``jax.eval_shape`` of the full-size
init, seconds for the large configs) is memoised per config in the test.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.policies as ref_policies
import repro.launch.specs as ref_specs_mod
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import cell_supported as ref_cell_supported
from repro.configs import get_config as ref_get_config
from repro.launch.mesh import dp_axes_of as ref_dp_axes_of
from repro.models import decode_state_specs as ref_decode_state_specs
from repro.models import param_specs as ref_param_specs
from repro.models.sharding import Shard as RefShard
from repro.optim import state_specs as ref_state_specs
from repro_torch.configs import ARCH_IDS, SHAPE_CELLS, ShardingPolicy
from repro_torch.configs import cell_supported, get_config
from repro_torch.launch import (auto_policy, dp_axes_of, input_specs,
                                production_mesh_shape,
                                rdp_production_mesh_shape)
from repro_torch.launch.dryrun import placed_bytes
from repro_torch.launch.specs import params_shapes
from repro_torch.models import Shard, decode_state_specs, param_specs
from repro_torch.optim import state_specs

MESHES = [("pod16x16", production_mesh_shape()),
          ("pod2x16x16", production_mesh_shape(multi_pod=True))]
RDP = [(f"rdp{b}x{'pod2x16x16' if mp else 'pod16x16'}",
        rdp_production_mesh_shape(b, multi_pod=mp)[0])
       for b in (2, 4, 8) for mp in (False, True)]

# policies beside the production ones, for the branches those never take
VARIANTS = [dict(attn_mode="head_dim"), dict(attn_mode="head_dim", fsdp=True),
            dict(shard_kv_heads=False, shard_vocab=False, fsdp=True,
                 dp_axes=("pod", "data")),
            dict(kv_seq_shard=True, shard_kv_heads=False),
            dict(seq_shard=True, sp_weightgrad_fix=True, attn_pad_heads=16)]


class _FakeMesh:
    """What the reference's policy and hooks read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


@pytest.fixture(scope="module", autouse=True)
def _memoised_ref_count():
    """The reference's parameter count per config, computed once."""
    orig = ref_policies._param_count
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_policies, "_param_count",
                   functools.lru_cache(maxsize=None)(orig))
        yield


def _norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(t) -> tuple:
    return tuple(_norm(e) for e in t)


def _policies():
    """(config, cell, mesh name, mesh shape, the port's policy, the
    reference's) for every config x cell x mesh, RDP's with the batch
    axis as the data axis (``launch.dryrun``'s rule)."""
    out = []
    for arch in ARCH_IDS:
        for cname in SHAPE_CELLS:
            for mname, shape in MESHES + RDP:
                cfg, rcfg = get_config(arch), ref_get_config(arch)
                pol = auto_policy(cfg, SHAPE_CELLS[cname], shape)
                rpol = ref_policies.auto_policy(rcfg, REF_CELLS[cname],
                                                _FakeMesh(shape))
                if mname.startswith("rdp"):
                    pol = dataclasses.replace(pol, dp_axes=("batch",))
                    rpol = dataclasses.replace(rpol, dp_axes=("batch",))
                out.append((arch, cname, mname, shape, pol, rpol))
    return out


@pytest.fixture(scope="module")
def policies(_memoised_ref_count):
    return _policies()


def test_mesh_shapes_match_reference():
    assert production_mesh_shape() == {"data": 16, "model": 16}
    assert production_mesh_shape(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    for _, shape in MESHES + RDP:
        assert dp_axes_of(shape) == ref_dp_axes_of(_FakeMesh(shape))
    shape, plan = rdp_production_mesh_shape(4, multi_pod=True)
    assert shape == {"replica": 8, "batch": 4, "model": 16}
    assert (plan.n_data, plan.n_batches, plan.replication) == (32, 4, 8)
    assert type(plan).__module__.startswith("repro_torch.")
    with pytest.raises(ValueError):
        rdp_production_mesh_shape(3)


def test_policy_fields_match_reference():
    want = {f.name: f.default for f in dataclasses.fields(
        ref_policies.ShardingPolicy)}
    assert {f.name: f.default for f in dataclasses.fields(
        ShardingPolicy)} == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_auto_policy_and_cell_supported_match_reference(policies, arch):
    rows = [p for p in policies if p[0] == arch]
    assert len(rows) == len(SHAPE_CELLS) * (len(MESHES) + len(RDP))
    for _, cname, mname, _, pol, rpol in rows:
        assert dataclasses.asdict(pol) == dataclasses.asdict(rpol), (
            cname, mname)
        assert cell_supported(get_config(arch), SHAPE_CELLS[cname]) == \
            ref_cell_supported(ref_get_config(arch), REF_CELLS[cname])


def test_auto_policy_expectations_of_the_reference():
    """``tests/test_sharding_equivalence.py::test_auto_policy_expectations``'
    values, from the port."""
    mesh = production_mesh_shape()
    cell = SHAPE_CELLS["train_4k"]
    p = auto_policy(get_config("qwen2.5-14b"), cell, mesh)
    assert p.attn_mode == "heads" and p.attn_pad_heads == 48
    assert p.fsdp and p.seq_shard and not p.sp_weightgrad_fix
    p = auto_policy(get_config("command-r-plus-104b"), cell, mesh)
    assert p.attn_pad_heads == 0
    assert p.fsdp and p.seq_shard and p.sp_weightgrad_fix
    p = auto_policy(get_config("qwen2-0.5b"), cell, mesh)
    assert p.attn_pad_heads == 16 and not p.fsdp and not p.seq_shard
    p = auto_policy(get_config("granite-34b"), cell, mesh)
    assert not p.shard_kv_heads and p.sp_weightgrad_fix
    dec = SHAPE_CELLS["decode_32k"]
    assert auto_policy(get_config("granite-34b"), dec, mesh).kv_seq_shard
    assert not auto_policy(get_config("olmoe-1b-7b"), dec, mesh).kv_seq_shard
    ok, reason = cell_supported(get_config("qwen2-0.5b"),
                                SHAPE_CELLS["long_500k"])
    assert not ok and "full-attention" in reason
    assert cell_supported(get_config("zamba2-7b"),
                          SHAPE_CELLS["long_500k"]) == (True, "")


def _same_tree(ref, port, lead=0, path=""):
    """The reference's spec tree against the port's: a port list is one
    stacked level of the reference's (its leading ``None`` stripped)."""
    if isinstance(port, list):
        assert port, path
        for i, p in enumerate(port):
            _same_tree(ref, p, lead + 1, f"{path}/{i}")
    elif isinstance(port, dict):
        assert isinstance(ref, dict) and set(ref) == set(port), path
        for k in port:
            _same_tree(ref[k], port[k], lead, f"{path}/{k}")
    else:
        assert isinstance(ref, P), path
        r = _spec(tuple(ref))
        assert r[:lead] == (None,) * lead, (path, r)
        assert r[lead:] == _spec(port), (path, r, port)


def _fits_params(specs, params, path=""):
    """One spec entry a dim of the port's meta parameter tree."""
    if isinstance(params, dict):
        assert set(specs) == set(params), path
        for k in params:
            _fits_params(specs[k], params[k], f"{path}/{k}")
    elif isinstance(params, list):
        assert isinstance(specs, list) and len(specs) == len(params), path
        for i, (s, p) in enumerate(zip(specs, params)):
            _fits_params(s, p, f"{path}/{i}")
    else:
        assert isinstance(specs, tuple) and len(specs) == params.dim(), (
            path, specs, tuple(params.shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_trees_match_reference(policies, arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    params = params_shapes(cfg)
    seen = set()
    for _, cname, _, _, pol, rpol in (p for p in policies if p[0] == arch):
        if not cell_supported(cfg, SHAPE_CELLS[cname])[0]:
            continue
        key = dataclasses.astuple(pol)
        if key in seen:
            continue
        seen.add(key)
        ps, rps = param_specs(cfg, pol), ref_param_specs(rcfg, rpol)
        _same_tree(rps, ps)
        _fits_params(ps, params)
        _same_tree(ref_state_specs(rps), state_specs(ps))
        assert state_specs(ps)["step"] == ()
        for shardable in (True, False):
            _same_tree(ref_decode_state_specs(rcfg, rpol, shardable),
                       decode_state_specs(cfg, pol, shardable))
    for kw in VARIANTS:
        pol, rpol = ShardingPolicy(**kw), ref_policies.ShardingPolicy(**kw)
        _same_tree(ref_param_specs(rcfg, rpol), param_specs(cfg, pol))
        for shardable in (True, False):
            _same_tree(ref_decode_state_specs(rcfg, rpol, shardable),
                       decode_state_specs(cfg, pol, shardable))
    assert seen


def _ref_hooks(policy, mesh_shape, x_heads):
    """The placements the reference's hooks apply: ``_c`` patched to
    record its spec and pass the tensor through."""
    rec = []

    def record(self, x, spec):
        if self.mesh is not None:  # the reference's _c is the identity
            rec.append(_spec(tuple(spec)))  # without a mesh
        return x

    mesh = None if mesh_shape is None else _FakeMesh(mesh_shape)
    shard = RefShard(mesh=mesh, policy=policy)
    x3 = jnp.zeros((2, 32, 8))
    x4 = jnp.zeros((2, 8, 4, 16))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RefShard, "_c", record)
        for name in ("activation", "full_seq", "mm_input", "logits",
                     "moe_tokens"):
            rec.clear()
            getattr(shard, name)(x3)
            out[name] = list(rec)
        for name in ("cache", "cache_long", "moe_buffer", "ssm_state"):
            rec.clear()
            getattr(shard, name)(x4)
            out[name] = list(rec)
        for heads in x_heads:
            rec.clear()
            shard.heads(jnp.zeros((2, 4, heads, 8)))
            out[f"heads{heads}"] = list(rec)
        rec.clear()
        y, vjp = jax.vjp(shard.mm_boundary, x3)
        vjp(y)
        out["mm_boundary"] = list(rec)
    return out


def _port_hooks(policy, mesh_shape, x_heads):
    shard = Shard(mesh_shape=mesh_shape, policy=policy)
    x3 = torch.zeros((2, 32, 8), device="meta")
    x4 = torch.zeros((2, 8, 4, 16), device="meta")

    def placed(x, got):
        if got is x:
            return []
        return [_spec(got)]

    out = {name: placed(x3, getattr(shard, name)(x3))
           for name in ("activation", "full_seq", "mm_input", "logits",
                        "moe_tokens")}
    out.update({name: placed(x4, getattr(shard, name)(x4))
                for name in ("cache", "cache_long", "moe_buffer",
                             "ssm_state")})
    for heads in x_heads:
        xh = torch.zeros((2, 4, heads, 8), device="meta")
        out[f"heads{heads}"] = placed(xh, shard.heads(xh))
    got = shard.mm_boundary(x3)
    out["mm_boundary"] = [] if got is x3 else [_spec(s) for s in got]
    return out


def test_shard_hooks_match_reference(policies):
    heads = (32, 14)  # a count the model axis divides, and one it does not
    cases = {dataclasses.astuple(p[4]): (p[4], p[5], p[3]) for p in policies}
    cases[("local",)] = (ShardingPolicy(), ref_policies.ShardingPolicy(),
                         None)
    for kw in VARIANTS:  # the branches no production policy takes
        cases[tuple(kw.items())] = (ShardingPolicy(**kw),
                                    ref_policies.ShardingPolicy(**kw),
                                    production_mesh_shape())
    assert any(c[0].sp_weightgrad_fix for c in cases.values())
    for pol, rpol, shape in cases.values():
        want = _ref_hooks(rpol, shape, heads)
        assert _port_hooks(pol, shape, heads) == want, (pol, shape)
        if shape is None:
            assert all(v == [] for v in want.values())
    local = Shard.local()
    assert local.n_data_shards() == 1 and local.dp == ("data",)
    s = Shard(mesh_shape=production_mesh_shape(multi_pod=True),
              policy=ShardingPolicy(dp_axes=("pod", "data")))
    assert s.n_data_shards() == 32 and s.m == "model"


@pytest.mark.parametrize("cname", list(SHAPE_CELLS))
def test_input_specs_match_reference(policies, cname):
    """The step's argument placements, and the shapes of its arguments
    past the parameters and AdamW state (batch, decode state, token),
    against the reference's at one pod."""
    arch = {"long_500k": "zamba2-7b"}.get(cname, "qwen2-0.5b")
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    (_, _, _, shape, pol, rpol), = [
        p for p in policies if p[:3] == (arch, cname, "pod16x16")]
    rargs, rspecs = ref_specs_mod.input_specs(rcfg, REF_CELLS[cname], rpol,
                                              _FakeMesh(shape))
    args, specs = input_specs(cfg, SHAPE_CELLS[cname], pol, shape)
    assert len(args) == len(specs) == len(rargs) == len(rspecs)
    for r, p in zip(rspecs, specs):
        _same_tree(r, p)
    first = 2 if SHAPE_CELLS[cname].kind == "train" else 1
    want = [tuple(t.shape) for t in jax.tree.leaves(rargs[first:])]
    assert [tuple(t.shape) for t in _leaves(args[first:])] == want
    assert all(t.device.type == "meta" for t in _leaves(args))


def _leaves(tree):
    """Leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_placed_bytes_divides_by_the_placed_axes():
    shape = {"pod": 2, "data": 16, "model": 16}
    t = torch.empty((64, 32, 8), dtype=torch.bfloat16, device="meta")
    full = 64 * 32 * 8 * 2
    assert placed_bytes(t, (None, None, None), shape) == full
    assert placed_bytes(t, (("pod", "data"), "model", None), shape) == \
        full // 512
    assert placed_bytes({"a": [t, t]}, {"a": [("data",), ()]}, shape) == \
        full // 16 + full
    with pytest.raises(ValueError):
        placed_bytes(t, (None,) * 4, shape)
