"""A copy of the benchmark at a tiny size, run on the CPU in a fresh
process: the tests' rehearsal of a cell's whole harness path."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_SIZES = {"hidden_size": 128, "intermediate_size": 32,
              "num_attention_heads": 2, "num_key_value_heads": 2,
              "num_experts": 8, "num_experts_per_tok": 2, "vocab_size": 256,
              "num_hidden_layers": 2}
TINY_PORT = {"n_layers": 2, "d_model": 128, "n_heads": 2, "n_kv_heads": 2,
             "d_ff": 32, "vocab_size": 256,
             "moe": {"n_experts": 8, "top_k": 2, "d_expert": 32}}
TINY_TRAFFIC = {"train": {"seq_len": 32, "warm_steps": 5,
                          "profile_seconds": 0.3, "profile_min_steps": 2},
                "prefill": {"batch": 2, "prompt_len": 64, "max_len": 128,
                            "pool_batches": 8, "check_batches": 3,
                            "check_span": 8, "check_positions": 8,
                            "profile_seconds": 0.3,
                            "profile_min_batches": 2}}


# the tiny size's own limits, set from CPU readings at this size (bf16
# program on 4 seeds: start grad_norm_gap <= 0.056, change_norm_gap <=
# 0.0033, grad_error_median_leaf <= 0.16, settled change_norm_gap <=
# 0.0033; on 6 seeds served_logit_gap_mean <= 0.40, logit_error_median <=
# 0.019, cache_error_worst_layer <= 0.134; the half-batch fault's start
# grad_error_median_leaf >= 0.74, the altered token's served gap >= 2.7;
# the float8 control's logit_error_median >= 0.145): a tiny model's
# near-ties weigh more than the full size's
TINY_LIMITS = {"train": {"start_grad_norm_gap": 0.15,
                         "start_change_norm_gap": 0.03,
                         "start_grad_error_median_leaf": 0.35,
                         "settled_change_norm_gap": 0.03},
               "prefill": {"served_logit_gap_mean": 0.6,
                           "logit_error_median": 0.08,
                           "cache_error_worst_layer": 0.3}}


def make(dest: Path) -> Path:
    """``dest`` holding ``bench/`` and a ``BENCHMARK.json`` whose
    configurations and traffic are cut to a tiny size.  Returns dest."""
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(TINY_SIZES, port=TINY_PORT)
        (dest / c["file"]).write_text(json.dumps(conf))
    for w in spec["workloads"]:
        p = dest / "bench" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(p.read_text())
        t.update(TINY_TRAFFIC[t["mode"]])
        p.write_text(json.dumps(t))
        (dest / "bench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(TINY_LIMITS[t["mode"]]))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


RUN = """
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = [{bench!r}, {src!r}]
import harness, torch
torch.set_num_threads(2)
undo = None
if {fault!r}:
    import calibrate
    undo = calibrate.FAULTS[{fault!r}]()
r = harness.run_cell(harness.Path({root!r}), {cell!r}, {seed!r}, {seconds!r},
                     {trace!r}, "cpu", t0)
print(json.dumps(r))
print(json.dumps(harness.forbidden_loaded()))
"""


def run(root: Path, cell: str, seed: int = 3_000_000_019, seconds=1.0,
        trace=False, fault=None):
    """Runs ``cell`` of the copy at ``root`` on the CPU in a fresh process.
    Returns (its result line, the forbidden modules it loaded, stderr)."""
    code = RUN.format(bench=str(root / "bench"), src=str(ROOT / "src"),
                      root=str(root), cell=cell, seed=seed, seconds=seconds,
                      trace=trace, fault=fault)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-4000:])
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr
