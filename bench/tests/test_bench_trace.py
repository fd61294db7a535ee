"""The harness's reduction of a profiler trace: the device's busy union,
its idle gaps named by the host spans open at their middle, and the
device time of what a host span launched (by launch correlation)."""

import json
import sys

import tiny_copy

sys.path[:0] = [str(tiny_copy.BENCH)]

import harness  # noqa: E402


def _trace(tmp_path):
    ev = [
        # the window and two host spans on the main thread (tid 1)
        {"ph": "X", "cat": "user_annotation", "name": "bench.profiled",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.optimizer",
         "ts": 40, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 70,
         "dur": 20, "tid": 1},
        # launches: two inside the optimizer span, one before it
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 42, "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 1, "tid": 1, "args": {"correlation": 3}},
        # device: [10, 30), [25, 35) overlap; [45, 55), [60, 65); one
        # kernel outside the window
        {"ph": "X", "cat": "kernel", "name": "void flash_wgmma<128>(int)",
         "ts": 10, "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 25,
         "dur": 10, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "adam_leaf", "ts": 45,
         "dur": 10, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "adam_leaf", "ts": 60,
         "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 200, "dur": 5,
         "args": {"correlation": 4}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return harness.read_trace(str(path))


def test_busy_idle_and_spans(tmp_path):
    t = _trace(tmp_path)
    assert t.busy_intervals() == [(10, 35), (45, 55), (60, 65)]
    assert abs(t.busy_s() - 40e-6) < 1e-12
    assert abs(t.window_s - 100e-6) < 1e-12
    gaps = t.idle_gaps()
    assert [round(g[1] * 1e6) for g in gaps] == [35, 10, 10, 5]
    # the longest gap, [65, 100), has aten::item open at its middle; the
    # first, [0, 10), only the window
    assert gaps[0][0] == "aten::item"
    assert gaps[1][0] == "between start and bench.optimizer"
    assert abs(t.span_device_seconds("bench.optimizer") - 15e-6) < 1e-12
    import re

    flash = re.compile(r"(?<![A-Za-z0-9_])(flash_wgmma)(?![A-Za-z0-9_])")
    assert abs(t.device_seconds(flash) - 20e-6) < 1e-12
    assert t.top_device_ops()[0][0] == "void flash_wgmma<128>(int)"
