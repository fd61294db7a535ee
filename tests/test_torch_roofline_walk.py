"""The roofline's walk of each step (``roofline.analysis`` through
``roofline.op_cost``), on the CPU and the meta device.

* The walked counts (FLOPs, bytes, the per-op table), carried from two
  small depths (and, xLSTM, two or three lengths) to a depth and a length
  that are not among the counted points, equal a direct count, key by
  key, within 1e-9; with the kernels' plain twins in their place too.
* The walk's matmul FLOPs equal ``FlopCounterMode``'s on the same step,
  exactly, for every family and kind, and with the plain twins.
* A train step's walk runs through the float32 gradient cast and the
  in-place AdamW update: one square root a leaf; the update's walk is
  also kept apart (``update_bytes``), the same at any batch, none in a
  prefill.
* ``_build.plain_on_meta`` routes a wrapper's meta call to its plain
  twin's ops and notes nothing; outside it the wrapper notes its work; a
  CPU tensor takes the plain version either way.
* ``analyze_cell``'s ``bytes_per_device`` is the walked count over the
  chips, beside ``modeled_bytes_per_device``; ``run_cell`` adds
  ``bytes_per_device_plain``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPE_CELLS, get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.ssm_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.launch.dryrun import run_cell
from repro_torch.models import lm
from repro_torch.roofline.analysis import _run, analyze_cell, count_step
from repro_torch.roofline.op_cost import walk_ops
from repro_torch.tree import tree_leaves

META = torch.device("meta")


def _reduced(arch, layers=None):
    cfg = reduced_config(get_config(arch))
    if layers is None:
        layers = {"hybrid": 7, "ssm": 8}.get(cfg.family, 3)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.family == "ssm":  # two segments of 3 mLSTM blocks and an sLSTM
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, slstm_layers=(3, 7), chunk=16))
    return cfg


def _flat(d, p=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, p + k + "/")
        elif isinstance(v, (int, float)):
            yield p + k, v


@pytest.mark.parametrize("arch,kind,seq,plain", [
    ("qwen2-0.5b", "train", 40, False), ("qwen2-0.5b", "prefill", 40, True),
    ("olmoe-1b-7b", "train", 40, False), ("zamba2-7b", "train", 64, True),
    ("zamba2-7b", "prefill", 64, False), ("whisper-medium", "train", 40,
                                          False),
    # five and four chunks of 16: past the counted lengths (32, 48, 64 for
    # train; 32, 48 for prefill)
    ("xlstm-350m", "train", 80, False), ("xlstm-350m", "prefill", 64,
                                          False),
    ("xlstm-350m", "decode", 64, False), ("zamba2-7b", "decode", 64, True)])
def test_walked_counts_carry_exactly(arch, kind, seq, plain):
    cfg = _reduced(arch)
    got = dict(_flat(count_step(cfg, kind, 2, seq, plain=plain)))
    want = dict(_flat(_run(cfg, kind, 2, seq, plain=plain)))
    assert set(want) <= set(got)
    assert want["walked_bytes"] > 0 and any("by_op/" in k for k in want)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-9, abs=1e-6), key


@pytest.mark.parametrize("arch,kind,plain", [
    ("qwen2-0.5b", "train", False), ("qwen2-0.5b", "prefill", True),
    ("qwen2-0.5b", "decode", False), ("deepseek-moe-16b", "train", False),
    ("zamba2-7b", "train", False), ("zamba2-7b", "decode", True),
    ("whisper-medium", "train", False), ("whisper-medium", "prefill", True),
    ("internvl2-76b", "prefill", False), ("xlstm-350m", "train", False)])
def test_walked_matmul_flops_equal_flop_counter_modes(arch, kind, plain):
    cfg = _reduced(arch)
    with FlopCounterMode(display=False) as counter:
        r = _run(cfg, kind, 2, 32, plain=plain)
    assert r["counted_flops"] == counter.get_total_flops() > 0
    assert r["walked_flops"] == r["flops"]
    assert not plain or r["kernels"] == {}


def test_a_train_walk_runs_the_optimizer():
    cfg = _reduced("qwen2-0.5b")
    r = _run(cfg, "train", 2, 32)
    leaves = tree_leaves(lm._build(None, cfg, META))
    assert r["by_op"]["aten.sqrt_"]["calls"] == len(leaves)
    assert r["by_op"]["aten.sqrt"]["calls"] == 1  # the global norm
    # the float32 state's in-place updates read and write 4 bytes a value
    n = sum(t.numel() for t in leaves)
    assert r["by_op"]["aten.sqrt_"]["bytes"] == 2 * 4 * n


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_the_update_is_walked_apart(arch):
    # a trainer's step of several backward passes runs one update, so the
    # update's walk is kept apart; its ops are also in the step's walk
    cfg = _reduced(arch)
    r = _run(cfg, "train", 2, 32)
    upd = r["update_by_op"]
    assert r["update_bytes"] == sum(row["bytes"] for row in upd.values()) > 0
    assert upd["aten.sqrt_"] == r["by_op"]["aten.sqrt_"]
    for name, row in upd.items():
        assert row["bytes"] <= r["by_op"][name]["bytes"], name
        assert row["flops"] == 0, name
    # the float32 casts of the bf16 gradients, one a bf16 leaf at least
    n = sum(t.dtype == torch.bfloat16
            for t in tree_leaves(lm._build(None, cfg, META)))
    assert upd["aten._to_copy"]["calls"] >= n > 0
    # independent of the batch: the same at twice the rows
    assert _run(cfg, "train", 4, 32)["update_bytes"] == r["update_bytes"]
    p = _run(cfg, "prefill", 2, 32)
    assert p["update_bytes"] == 0.0 and p["update_by_op"] == {}


def test_plain_on_meta_routes_the_wrappers_meta_calls():
    q = torch.empty((1, 32, 2, 64), dtype=torch.bfloat16, device=META)
    x = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device=META)
    dt = torch.empty((1, 64, 2), device=META)
    hv = torch.empty((2,), device=META)
    bc = torch.empty((1, 64, 1, 16), dtype=torch.bfloat16, device=META)

    def step():
        return flash_attention(q, q, q), ssd_scan(x, dt, hv, bc, bc, hv)

    with _build.plain_on_meta():
        assert _build.meta_runs_plain()
        with _build.record_meta_work() as work:
            plain = walk_ops(step)
    assert not _build.meta_runs_plain() and work == []
    want = walk_ops(lambda: (flash_attention_plain(q, q, q),
                             ssd_scan_plain(x, dt, hv, bc, bc, hv)))
    assert plain.by_op == want.by_op and plain.bytes > 0
    noted = walk_ops(step)
    assert set(noted.by_op) == {"flash_attention", "ssd_scan"}
    # a CPU tensor takes the plain version, inside the route or not
    qc = torch.randn((1, 8, 2, 64))
    with _build.plain_on_meta(), _build.record_meta_work() as work:
        out = flash_attention(qc, qc, qc)
    assert work == [] and torch.equal(out, flash_attention_plain(qc, qc, qc))


def test_analyze_cell_reads_the_walk(tmp_path):
    cfg = get_config("qwen2-0.5b")
    cell = SHAPE_CELLS["decode_32k"]
    counts = count_step(cfg, "decode", cell.global_batch, cell.seq_len)
    r = analyze_cell(cfg, cell, chips=256, counts=counts)
    assert r["bytes_per_device"] == counts["walked_bytes"] / 256
    assert r["modeled_bytes_per_device"] == counts["bytes"] / 256
    assert r["terms"]["memory_s"] == r["bytes_per_device"] / r["peaks"][
        "hbm_bytes_per_s"]
    rep = run_cell("qwen2-0.5b", "decode_32k", False, tmp_path)
    assert rep["bytes_per_device"] == r["bytes_per_device"]
    # the plain decode attention reads the whole masked cache, the kernel
    # only its valid positions, and materialises the scores
    assert rep["bytes_per_device_plain"] > rep["bytes_per_device"]
    # no kernel wrapper on the xLSTM's path: one walk serves both
    rep = run_cell("xlstm-350m", "decode_32k", False, tmp_path)
    assert rep["bytes_per_device_plain"] == rep["bytes_per_device"]
    assert rep["counts"]["kernels"] == {}
