"""The port's H100 roofline and dry-run, on the CPU and the meta device.

* ``model_flops`` equals the reference's for every config x cell.
* The attention and scan wrappers on meta tensors allocate only their
  outputs, launch nothing, and note their kernel's work by the formulas of
  the kernel table's bound column; on a CPU tensor they run the plain
  versions as before.
* ``count_step``'s counts, from two small depths (and, xLSTM, two lengths)
  carried to the full model, equal a direct count of the full model, key
  by key.
* The counted train / prefill / decode FLOPs of reduced qwen2-0.5b
  (dense), olmoe-1b-7b (MoE) and zamba2-7b (hybrid) against a hand count
  from the shapes: forward matmuls 2 x tokens x weights, backward twice
  that; attention forward 4 d a visible (query, key) pair and head (causal
  at half), backward (``flash_attention_grad``) 5 products over the full
  square, 10 d a pair and head; MoE experts over the capacity buffer (E x
  C rows); decode's attention over the cache; hybrid's SSD scan forward by
  the kernel's formula at the model's chunk, its backward (the plain
  chunked scan recomputed, then its gradient) three times that.  All
  within 1e-9.
* ``train_memory``'s phases from a tree's leaves, and its reading of
  ``chip_smoke.py``'s runs (``PERF.md``): the update's four float32
  temporaries of the largest leaf, the aggregation's mean built leaf by
  leaf.
* ``python -m repro_torch.launch.dryrun`` on one pair and on ``--all
  --shape decode_32k``: a report per (arch, shape), skipped pairs with the
  reference's reason, the roofline fields, no ``jax`` imported.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro.roofline.analysis import model_flops as ref_model_flops
from repro_torch.configs import (ARCH_IDS, SHAPE_CELLS, get_config,
                                 reduced_config)
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_work)
from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention,
                                                     flash_attention_work)
from repro_torch.kernels.ssm_scan.ops import (ssd_scan, ssd_scan_plain,
                                              ssd_scan_work)
from repro_torch.launch.dryrun import train_memory
from repro_torch.launch.specs import params_shapes
from repro_torch.models import active_params
from repro_torch.models.moe import router_capacity
from repro_torch.roofline.analysis import (_run, analyze_cell, count_step,
                                           model_flops)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    n = active_params(cfg)
    for name in SHAPE_CELLS:
        assert model_flops(cfg, SHAPE_CELLS[name], n) == ref_model_flops(
            rcfg, REF_CELLS[name], n)


def test_meta_wrappers_note_their_work_and_launch_nothing():
    _build.reset_launch_counts()
    q = torch.empty((2, 48, 4, 64), dtype=torch.bfloat16, device=META)
    k = torch.empty((2, 48, 2, 64), dtype=torch.bfloat16, device=META)
    with _build.record_meta_work() as work:
        out = flash_attention(q, k, k, causal=True)
        FlashAttentionFn.apply(q.clone().requires_grad_(), k, k, False, 0)
        qd = torch.empty((2, 4, 64), dtype=torch.bfloat16, device=META)
        kc = torch.empty((2, 64, 2, 64), dtype=torch.bfloat16, device=META)
        dout = decode_attention(qd, kc, kc, 40)
        x = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device=META)
        dt = torch.empty((2, 64, 4), device=META)
        h = torch.empty((4,), device=META)
        bc = torch.empty((2, 64, 1, 16), dtype=torch.bfloat16, device=META)
        y, st = ssd_scan(x, dt, h, bc, bc, h)
    assert out.shape == q.shape and out.device.type == "meta"
    assert dout.shape == qd.shape and y.shape == x.shape
    assert st.shape == (2, 4, 16, 32) and st.dtype == torch.float32
    assert work == [
        ("flash_attention",
         *flash_attention_work(2, 48, 48, 4, 2, 64, True)),
        ("flash_attention",
         *flash_attention_work(2, 48, 48, 4, 2, 64, False)),
        ("decode_attention", *decode_attention_work(2, 4, 2, 64, 40)),
        ("ssd_scan", *ssd_scan_work(2, 64, 4, 1, 32, 16))]
    assert set(_build.launch_counts().values()) == {0}
    # causal pairs: sq (sq + 1) / 2, and the q_offset rule
    assert flash_attention_work(1, 4, 4, 1, 1, 1, True)[0] == 4.0 * 10
    assert flash_attention_work(1, 2, 6, 1, 1, 1, True, 4)[0] == 4.0 * 11
    with _build.record_meta_work() as none:  # the CPU keeps the plain path
        xc = torch.randn((1, 32, 2, 16))
        bcc = torch.randn((1, 32, 1, 16))
        args = (xc, torch.rand((1, 32, 2)), torch.zeros(2), bcc, bcc,
                torch.ones(2))
        yc, _ = ssd_scan(*args)
    assert none == [] and torch.equal(yc, ssd_scan_plain(*args)[0])


def _flat(d, p=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, p + k + "/")
        elif isinstance(v, (int, float)):
            yield p + k, v


@pytest.mark.parametrize("arch,kind", [
    ("qwen2-0.5b", "train"), ("deepseek-moe-16b", "train"),
    ("zamba2-7b", "train"), ("zamba2-7b", "decode"),
    ("whisper-medium", "prefill"), ("internvl2-76b", "prefill"),
    ("xlstm-350m", "train"), ("xlstm-350m", "prefill")])
def test_count_step_extrapolation_is_exact(arch, kind):
    """Depth points (and xLSTM lengths) carried to the full model equal
    the full model's direct count, key by key."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              n_layers={"hybrid": 7, "ssm": 8}.get(
                                  get_config(arch).family, 3))
    if cfg.family == "ssm":  # two segments of 3 mLSTM blocks and an sLSTM
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, slstm_layers=(3, 7), chunk=16))
    got = count_step(cfg, kind, 2, 48)
    want = _run(cfg, kind, 2, 48)
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(w) <= set(g)
    for key, v in w.items():
        assert g[key] == pytest.approx(v, rel=1e-9, abs=1e-6), key


def _hand_train_flops(cfg, b, s):
    """Train FLOPs of a dense, MoE or hybrid config from its shapes."""
    d, hd, hq, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    t = b * s
    attn_w = d * hd * (hq + 2 * kv) + hq * hd * d
    mlp_w = 3 * d * cfg.d_ff
    causal_pairs = s * (s + 1) // 2
    attn_fwd = 4.0 * b * hq * hd * causal_pairs
    # the backward kernel's noted work: 10 hd a visible pair and head
    attn_bwd = 10.0 * b * hq * hd * causal_pairs
    unembed = 2.0 * t * d * cfg.vocab_size
    fwd, extra = unembed, 0.0
    if cfg.family == "dense":
        fwd += cfg.n_layers * 2.0 * t * (attn_w + mlp_w)
        extra += cfg.n_layers * (attn_fwd + attn_bwd)
    elif cfg.family == "moe":
        moe = cfg.moe
        cap = router_capacity(moe, t)
        n_dense = 1 if moe.first_layer_dense else 0
        per_moe = (2.0 * t * attn_w + 2.0 * t * d * moe.n_experts
                   + 2.0 * moe.n_experts * cap * 3 * d * moe.d_expert
                   + 2.0 * t * 3 * d * moe.n_shared * moe.d_expert)
        fwd += n_dense * 2.0 * t * (attn_w + mlp_w)
        fwd += (cfg.n_layers - n_dense) * per_moe
        extra += cfg.n_layers * (attn_fwd + attn_bwd)
    else:  # hybrid: Mamba-2 blocks, the shared attention block a segment
        ssm = cfg.ssm
        d_in = ssm.expansion * d
        nh = d_in // ssm.head_dim
        gn = ssm.n_groups * ssm.state_dim
        proj = 2 * d_in + 2 * gn + nh
        n_seg = cfg.n_layers // cfg.hybrid.attn_every
        fwd += cfg.n_layers * 2.0 * t * (d * proj + d_in * d)
        fwd += n_seg * 2.0 * t * (attn_w + mlp_w)
        extra += n_seg * (attn_fwd + attn_bwd)
        scan = ssd_scan_work(b, s, nh, ssm.n_groups, ssm.head_dim,
                             ssm.state_dim, chunk=ssm.chunk)[0]
        # the backward kernel's noted work at its chunk of 64: G, Q, W^T dy,
        # M^T C, M B and four state products a (row, head, chunk)
        n, p, cl = ssm.state_dim, ssm.head_dim, 64
        scan_bwd = (2.0 * b * nh * -(-s // cl)
                    * (cl * cl * (3 * n + 2 * p) + 4 * cl * n * p))
        extra += cfg.n_layers * (scan + scan_bwd)
    return 3 * fwd + extra


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "deepseek-moe-16b", "zamba2-7b"])
def test_counted_train_flops_match_a_hand_count(arch):
    cfg = reduced_config(get_config(arch))
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=5)  # a trailing block too
    b, s = 2, 64
    got = count_step(cfg, "train", b, s)["flops"]
    assert got == pytest.approx(_hand_train_flops(cfg, b, s), rel=1e-9)


def test_counted_prefill_and_decode_flops_match_a_hand_count():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    d, hd, hq, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    b, s = 2, 64
    w = d * hd * (hq + 2 * kv) + hq * hd * d + 3 * d * cfg.d_ff
    pre = count_step(cfg, "prefill", b, s)
    # prefill: every position through the layers, the last to the logits
    want = (cfg.n_layers * (2.0 * b * s * w
                            + 4.0 * b * hq * hd * s * (s + 1) // 2)
            + 2.0 * b * d * cfg.vocab_size)
    assert pre["flops"] == pytest.approx(want, rel=1e-9)
    assert pre["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    dec = count_step(cfg, "decode", b, s)
    # one token against s - 1 cached positions and itself
    want = (cfg.n_layers * (2.0 * b * w + 4.0 * b * hq * hd * s)
            + 2.0 * b * d * cfg.vocab_size)
    assert dec["flops"] == pytest.approx(want, rel=1e-9)
    assert dec["activation_bytes"] == 0


def test_analyze_cell_reports_the_reference_fields():
    cfg = get_config("qwen2-0.5b")
    r = analyze_cell(cfg, SHAPE_CELLS["decode_32k"], chips=256)
    for key in ("terms", "dominant", "model_flops_per_device",
                "flops_per_device", "bytes_per_device", "useful_flop_ratio",
                "roofline_fraction"):
        assert key in r
    assert r["terms"]["collective_s"] == 0.0
    assert r["dominant"] == "memory_s"  # a decode step reads its cache
    assert 0 < r["useful_flop_ratio"] < 1
    assert 0 < r["roofline_fraction"] < 1


def test_train_memory_phases():
    bf, f32 = torch.bfloat16, torch.float32
    params = {"a": torch.empty((1000,), dtype=bf, device=META),
              "b": [torch.empty((10, 10), dtype=f32, device=META)],
              "c": torch.empty((500,), dtype=bf, device=META)}
    n, native = 1600, 2 * 1500 + 4 * 100
    one = train_memory(params, 1, 0)
    assert one["phases"]["update"] == native + 12 * n + 4 * n + 16 * 1000
    assert one["peak_phase"] == "update"
    three = train_memory(params, 3, 7)
    # the mean so far and two float32 temporaries of the leaf summed:
    # largest at "c" (4 x 1,100 before it, 8 x 500)
    assert three["phases"]["aggregation"] == (native + 12 * n + 12 * n
                                              + 4 * 1100 + 8 * 500)
    assert three["phases"]["backward"] == native + 12 * n + 8 * n + 7 + native
    assert three["reckoning_14_4_4"] == 14 * n + 16 * n


def test_train_memory_reads_the_card_runs():
    """``chip_smoke.py``'s paths (PERF.md, run E of the MoE / VLM training
    slice): internvl2 at depth 1, one distinct batch, peaks in AdamW's
    update (the mean gradient tree and four float32 temporaries of the
    1.05 G-element embedding); olmoe at depth 4 in the aggregation of the
    step at B 4 that computed three distinct batches."""
    cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=1)
    mem = train_memory(params_shapes(cfg), 1, 0)
    p = mem["parameters"]
    assert p == 2_965_397_504 and mem["largest_leaf"] == 128_256 * 8_192
    assert mem["peak_phase"] == "update"
    assert mem["peak_bytes"] == 18 * p + 16 * 128_256 * 8_192
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=4)
    mem = train_memory(params_shapes(cfg), 3, 0)
    assert mem["parameters"] == 1_884_309_504
    assert mem["peak_phase"] == "aggregation"
    assert 30 * mem["parameters"] < mem["peak_bytes"] < 30.3 * mem[
        "parameters"]


def _dryrun(tmp_path, *args):
    tmp_path.mkdir(parents=True, exist_ok=True)
    code = ("import runpy, sys; sys.argv = ['dryrun'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, *args, "--out",
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout, {p.name: json.loads(p.read_text())
                        for p in tmp_path.glob("*.json")}


def test_dryrun_cli_one_pair(tmp_path):
    out, reports = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape",
                           "train_4k")
    r = reports["qwen2-0.5b__train_4k__pod16x16.json"]
    assert r["status"] == "ok" and r["mesh"] == {"data": 16, "model": 16}
    assert r["chips"] == 256 and r["dominant"] in r["terms"]
    assert 0.5 < r["useful_flop_ratio"] < 1
    placed = r["placed_bytes_per_device"]
    assert set(placed) == {"params", "opt_state", "batch", "lr"}
    assert 0 < placed["params"] < placed["opt_state"]
    oc = r["one_card"]
    # 494 M parameters, but 256 rows of 4,096 positions of activations
    assert not oc["fits"] and oc["peak_phase"] == "backward"
    assert oc["phases"]["update"] < oc["card_bytes"] < oc["bytes"]
    assert r["counts"]["kernels"]["flash_attention"]["calls"] == 24
    assert "all dry-run cells passed" in out


def test_dryrun_cli_all_decode(tmp_path):
    _, reports = _dryrun(tmp_path, "--all", "--shape", "decode_32k")
    assert sorted(reports) == sorted(f"{a}__decode_32k__pod16x16.json"
                                     for a in ARCH_IDS)
    for r in reports.values():
        assert r["status"] == "ok" and r["dominant"] == "memory_s"
        assert r["bytes_per_device"] > 0 and r["terms"]["collective_s"] == 0
        assert isinstance(r["one_card"]["fits"], bool)
    _, skipped = _dryrun(tmp_path / "long", "--arch", "qwen2-0.5b",
                         "--shape", "long_500k")
    r, = skipped.values()
    assert r["status"] == "skipped" and "full-attention" in r["reason"]
