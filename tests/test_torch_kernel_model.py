"""The port's kernel-substitution model and hill-climb against the
reference's (``roofline.kernel_model``, ``roofline.hillclimb``).

* For every counted (arch, shape) pair of the 16 x 16 mesh shape, with the
  two walks (``_walk_attention``, ``_walk_mlstm``) patched to return 0 in
  both packages, and again to a fixed 2^30 bytes: ``attention_traffic``'s
  calls, kernel bytes (the reference's ``flash_bytes``) and plain bytes
  (``xla_bytes``), ``floor_bytes`` and ``kernel_adjusted_terms`` on a
  synthetic report equal the reference's exactly (its memory term each
  package's bytes over its own ``HBM_BW``).  The reference's policy is the
  port's ``auto_policy``, field for field (held equal to the reference's
  in ``tests/test_torch_sharding.py``); its ``count_params`` is memoised
  per config.
* One real walk of a small causal attention (``flash_attention_plain`` on
  meta tensors) equals its hand count from the shapes, op by op.
* ``kernel_adjusted_terms`` names what set its bytes (``bound``): the
  substitution, the floor or the cap, each reached by one report.
* ``hillclimb.run`` over a directory holding two reports written by
  ``dryrun.run_cell``: the two cells, each with its three sets of terms.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import functools
import json

import pytest
import torch

import repro.models as ref_models
import repro.roofline.kernel_model as RK
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro.configs.base import ShardingPolicy as RefPolicy
from repro.roofline.analysis import HBM_BW as REF_HBM_BW
from repro_torch.configs import (ARCH_IDS, SHAPE_CELLS, cell_supported,
                                 get_config)
from repro_torch.launch import auto_policy, production_mesh_shape
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline import HBM_BW, hillclimb
from repro_torch.roofline import kernel_model as TK
from repro_torch.roofline.op_cost import walk_ops

MESH = production_mesh_shape()
PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPE_CELLS
         if cell_supported(get_config(a), SHAPE_CELLS[s])[0]]
_ref_count_params = functools.lru_cache(maxsize=None)(ref_models.count_params)


def test_the_pairs_are_the_dry_runs_counted_cells():
    assert len(PAIRS) == 32  # 40 pairs, 8 long_500k skipped


@pytest.mark.parametrize("walked", [0.0, float(2 ** 30)])
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_kernel_model_arithmetic_equals_the_references(monkeypatch, arch,
                                                       shape, walked):
    for mod in (RK, TK):
        monkeypatch.setattr(mod, "_walk_attention", lambda *a: walked)
        monkeypatch.setattr(mod, "_walk_mlstm", lambda *a: walked)
    monkeypatch.setattr(ref_models, "count_params", _ref_count_params)
    cfg, cell = get_config(arch), SHAPE_CELLS[shape]
    rcfg, rcell = ref_get_config(arch), REF_CELLS[shape]
    policy = auto_policy(cfg, cell, MESH)
    rpolicy = RefPolicy(**dataclasses.asdict(policy))

    port = TK.attention_traffic(cfg, cell, policy, MESH)
    ref = RK.attention_traffic(rcfg, rcell, rpolicy, MESH)
    assert port == {"plain_bytes": ref["xla_bytes"],
                    "kernel_bytes": ref["flash_bytes"],
                    "calls": ref["calls"]}
    floor = TK.floor_bytes(cfg, cell, policy, MESH)
    assert floor == RK.floor_bytes(rcfg, rcell, rpolicy, MESH) > 0
    if cell.kind != "decode" and cfg.family != "ssm" or (
            cfg.family == "ssm" and cell.kind == "train"):
        assert port["calls"] > 0 and port["kernel_bytes"] > 0
    # reports above, at and below the floor
    for scale in (3.0, 1.0, 0.5):
        rep_bytes = scale * (floor + port["kernel_bytes"]) + walked
        terms = {"compute_s": 0.25, "memory_s": rep_bytes / HBM_BW,
                 "collective_s": 0.0}
        got = TK.kernel_adjusted_terms(
            {"bytes_per_device": rep_bytes, "terms": terms}, cfg, cell,
            policy, MESH)
        want = RK.kernel_adjusted_terms(
            {"bytes_per_device": rep_bytes,
             "terms": dict(terms, memory_s=rep_bytes / REF_HBM_BW)},
            rcfg, rcell, rpolicy, MESH)
        assert got["bytes_per_device"] == want["bytes_per_device"]
        assert got["terms"] == dict(
            terms, memory_s=want["bytes_per_device"] / HBM_BW)
        assert got["dominant"] == max(got["terms"], key=got["terms"].get)
        assert got["attention_traffic"] == port
    assert TK.FLASH_BWD_FACTOR == RK.FLASH_BWD_FACTOR


def test_plain_attention_walk_equals_its_hand_count():
    """``flash_attention_plain`` (b 2, s 16, 4 heads of 64, bf16, causal)
    walked on meta tensors: q scaled; the first einsum copies q and k into
    its bmm's layout; the float32 logits; the positions (two aranges, the
    query offset's add, a >= into an (s, s) mask); the scalar fill and the
    masked where; the softmax; the weights back to bf16; the second
    einsum copies v; each op its operands read and result written."""
    b, s, h, d = 2, 16, 4, 64
    TK._walk_attention.cache_clear()
    n = b * s * h * d * 2  # q, k, v or the output, bf16
    s2, s4 = b * h * s * s * 2, b * h * s * s * 4  # scores, bf16 / f32
    pos = s * 8  # int64 positions
    want = {
        "aten.mul": (1, 2 * n),
        "aten.clone": (3, 6 * n),
        "aten.bmm": (2, (2 * n + s2) + (s2 + 2 * n)),
        "aten._to_copy": (2, 2 * (s2 + s4)),
        "aten.arange": (2, 2 * pos),
        "aten.add": (1, 2 * pos),
        "aten.ge": (1, 2 * pos + s * s),
        "aten.scalar_tensor": (1, 4),
        "aten.where": (1, s * s + 2 * s4 + 4),
        "aten._softmax": (1, 2 * s4),
    }
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16,
                    device=torch.device("meta"))
    cost = walk_ops(flash_attention_plain, q, q, q, causal=True)
    assert {k: (v["calls"], v["bytes"]) for k, v in cost.by_op.items()} \
        == want
    assert cost.flops == 2 * (2.0 * b * h * s * s * d)
    assert TK._walk_attention(b, s, s, h, d, False) == sum(
        v for _, v in want.values())
    # the backward through autograd adds to the forward's traffic
    assert TK._walk_attention(b, s, s, h, d, True) > cost.bytes


@pytest.mark.parametrize("bound", ["substitution", "floor", "cap"])
def test_kernel_adjusted_terms_names_its_bound(monkeypatch, bound):
    monkeypatch.setattr(TK, "_walk_attention", lambda *a: float(2 ** 30))
    cfg, cell = get_config("qwen2-0.5b"), SHAPE_CELLS["train_4k"]
    policy = auto_policy(cfg, cell, MESH)
    traffic = TK.attention_traffic(cfg, cell, policy, MESH)
    plain, kernel = traffic["plain_bytes"], traffic["kernel_bytes"]
    assert plain > 2 * kernel > 0
    floor = TK.floor_bytes(cfg, cell, policy, MESH) + kernel
    rep_bytes = {"substitution": floor + plain, "floor": floor + plain / 2,
                 "cap": floor / 2}[bound]
    got = TK.kernel_adjusted_terms(
        {"bytes_per_device": rep_bytes,
         "terms": {"compute_s": 0.0, "memory_s": rep_bytes / HBM_BW,
                   "collective_s": 0.0}}, cfg, cell, policy, MESH)
    assert got["bound"] == bound
    assert got["bytes_per_device"] == {
        "substitution": rep_bytes - plain + kernel, "floor": floor,
        "cap": rep_bytes}[bound]


def test_hillclimb_over_two_dryrun_reports(tmp_path):
    for shape in ("train_4k", "prefill_32k"):
        run_cell("qwen2-0.5b", shape, False, tmp_path)
    out = tmp_path / "hillclimb.json"
    hillclimb.main(["--reports", str(tmp_path), "--out", str(out)])
    res = json.loads(out.read_text())
    assert sorted(res) == ["qwen2-0.5b__prefill_32k__pod16x16",
                           "qwen2-0.5b__train_4k__pod16x16"]
    for key, v in res.items():
        rep = json.loads((tmp_path / f"{key}.json").read_text())
        assert v["as_run"]["terms"] == rep["terms"]
        assert v["as_run"]["bytes_per_device"] == rep["bytes_per_device"]
        plain = rep["bytes_per_device_plain"]
        assert v["as_plain"]["terms"] == dict(rep["terms"],
                                              memory_s=plain / HBM_BW)
        sub = v["kernel_substituted"]
        assert sub["bytes_per_device"] <= plain
        assert sub["terms"]["memory_s"] == sub["bytes_per_device"] / HBM_BW
        assert sub["attention_plain_bytes"] > sub["attention_kernel_bytes"]
        assert sub["bound"] in ("substitution", "floor", "cap")
    # prefill: the plain attention's score tensors, gone from the kernel's
    # run and from the substituted model
    pre = res["qwen2-0.5b__prefill_32k__pod16x16"]
    assert (pre["kernel_substituted"]["bytes_per_device"]
            < pre["as_run"]["bytes_per_device"]
            < pre["as_plain"]["bytes_per_device"])
