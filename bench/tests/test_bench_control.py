"""The control, kept runnable: the float32 reference put in the program's
place and computed in float8, read as the program is.  On the CPU at a
tiny size it reads above the program; on the card (``cuda``), at the
cell's own size, it fails the cell's limits while the program passes
them."""

import json
import os
import subprocess
import sys

import pytest
import tiny_copy

ROOT, BENCH = tiny_copy.ROOT, tiny_copy.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


# a window long enough to serve the batches a prefill check samples from
SECONDS = {"cpu": {"train": 1, "prefill": 1},
           "cuda": {"train": 2, "prefill": 16}}


def _calibrate(root, cell, seed, device):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in spec["workloads"]
                   if w["name"] == cell)
    mode = json.loads((root / "bench" / "traffic" / f"{traffic}.json")
                      .read_text())["mode"]
    out = subprocess.run(
        [sys.executable, str(root / "bench" / "calibrate.py"), "--workload",
         cell, "--seconds", str(SECONDS[device][mode]), "--seeds", str(seed),
         "--control", str(seed), "--device", device],
        capture_output=True, text=True, timeout=1800,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", [3_000_000_101, 3_000_000_102])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_program_at_a_tiny_size(tiny, cell,
                                                           seed):
    got = _calibrate(tiny, cell, seed, "cpu")
    prog, ctrl = got["program"], got["control"]
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in prog) >= 2.0, got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    got = _calibrate(ROOT, cell, 3_000_000_103, "cuda")
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["control"].items()), got
