"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* In a subprocess with ``sys.modules["jax"] = None``,
  ``sys.modules["ml_dtypes"] = None`` and ``sys.modules["repro"] = None``
  (so any import of them fails), every module of ``repro_torch`` imports
  (the training path's ``data``, ``optim``, ``checkpoint``,
  ``launch.steps`` and ``launch.train`` included), and so does
  ``chip_smoke`` as a module, without running.
* With no device given, the planner, the serving engine and the trainer
  run on CUDA or raise — never on the CPU behind the caller's back.
* A CPU tensor through each kernel wrapper (and through the trainable
  ``FlashAttentionFn``, forward and backward) runs the plain version and
  leaves every launch counter at 0.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert {"repro_torch.core.planner", "repro_torch.core.simulator",
            "repro_torch.kernels.sojourn_sweep.kernel",
            "repro_torch.kernels.coded.ops", "repro_torch.convert",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.models.lm", "repro_torch.launch.serve",
            "repro_torch.configs.qwen2_0_5b",
            "repro_torch.configs.zamba2_7b", "repro_torch.models.ssm",
            "repro_torch.models.zamba",
            "repro_torch.kernels.ssm_scan.ops",
            "repro_torch.core.tuner",
            "repro_torch.core.gradient_coding",
            "repro_torch.serving.arrivals", "repro_torch.serving.queueing",
            "repro_torch.serving.engine",
            "repro_torch.distributed", "repro_torch.distributed.collectives",
            "repro_torch.distributed.elastic", "repro_torch.distributed.fault",
            "repro_torch.cluster", "repro_torch.cluster.protocol",
            "repro_torch.cluster.payloads", "repro_torch.cluster.worker",
            "repro_torch.cluster.harness", "repro_torch.cluster.chaos",
            "repro_torch.cluster.coordinator",
            "repro_torch.launch.cluster",
            "repro_torch.tree", "repro_torch.data.pipeline",
            "repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.optim.compression",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.steps", "repro_torch.launch.train"} <= set(mods)
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['ml_dtypes'] = None",
        "sys.modules['repro'] = None",
        f"sys.path[:0] = [{os.path.abspath(SRC)!r}, {os.path.abspath(ROOT)!r}]",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in"
        " sys.modules.items() if v is not None)",
        "assert not any(k.startswith('repro.') for k in sys.modules)",
        "print('isolated', len(sys.modules))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_default_planner_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch.core.order_stats import ShiftedExponential
    from repro_torch.core.planner import ClusterSpec, Objective, SimulatedPlanner
    from repro_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        SimulatedPlanner().plan(
            ClusterSpec(n_workers=8, dist=ShiftedExponential(0.1, 2.0)),
            Objective(metric="p99", utilization=0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    from repro_torch.serving import ReplicatedServingEngine, ServeEngineConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicatedServingEngine(ServeEngineConfig())
    from repro_torch.launch.train import Trainer, TrainerConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TrainerConfig(steps=1))


def test_cpu_tensors_leave_launch_counters_at_zero():
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.coded import combine
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention)
    from repro_torch.kernels.sojourn_sweep import coded_cells, sojourn_cells
    from repro_torch.kernels.ssm_scan import ssd_scan

    reset_launch_counts()
    f32, i32 = torch.float32, torch.int32
    sojourn_cells(torch.arange(4, dtype=f32), torch.ones((1, 4, 2)),
                  torch.ones((1, 4, 2)), torch.tensor([0, 3], dtype=i32),
                  torch.full((1, 2), float("inf")),
                  torch.ones((2, 4), dtype=torch.bool),
                  torch.tensor([2], dtype=i32), resolve=False)
    coded_cells(torch.ones((1, 3, 5)), torch.tensor([2], dtype=i32))
    combine(torch.ones((2, 3)), torch.ones((3, 4)))
    q, k = torch.ones((1, 4, 2, 64)), torch.ones((1, 4, 1, 64))
    flash_attention(q, k, k)
    qg = q.clone().requires_grad_(True)
    FlashAttentionFn.apply(qg, k, k, True, 0).sum().backward()
    assert qg.grad is not None
    decode_attention(q[:, 0], k, k, 3)
    ssd_scan(torch.ones((1, 5, 2, 16)), torch.ones((1, 5, 2)), torch.zeros(2),
             torch.ones((1, 5, 1, 16)), torch.ones((1, 5, 1, 16)),
             torch.ones(2))
    assert launch_counts() == {"sojourn_cells": 0, "coded_cells": 0,
                               "combine": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0,
                               "decode_attention": 0, "ssd_scan": 0,
                               "ssd_scan_bwd": 0}
