"""The benchmark's core, shared by every cell: it finds a cell's pieces by
name, makes weights and traffic from the seed, reads the profiler's
trace, runs the per-layer readers, judges the checks and prints the
result.  Nothing in it belongs to one configuration, traffic mix or
metric: those are files of their own under ``bench/``:

* ``configs/<config>.json``: the published sizes, the source, the cuts,
  the port's departures with their values as run, the port's arch and
  fields, and the model's family;
* ``models/<family>.py``: a family's model FLOPs, the hand-written kernel
  calls of a step, and where the program's cache holds what is compared;
* ``reference/<family>.py``: a family's plain reference;
* ``traffic/<traffic>.json``: a traffic mix's parameters, its ``mode``;
* ``modes/<mode>.py``: the driver of a kind of traffic (``run(ctx)``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read(r)``);
* ``kernels/<kernel>.json``: the kernel names a roofline metric sums;
* ``limits/<cell>.json``: the limits of a cell's checks.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
WEIGHT_CHUNK = 1 << 30  # values a normal_ call draws


# -- finding a cell's pieces ------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """A module from its file (names may hold dots, as metric names do)."""
    name = name or "bench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    spec: dict  # the whole BENCHMARK.json
    entry: dict  # the workloads entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json

    @property
    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def load_cell(root: Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    bench = root / spec["paths"][0]
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    return Cell(name, spec, entry, config, traffic, limits)


def reference_module(config: dict):
    return load_module(BENCH / "reference" / f"{config['family']}.py")


def family_module(config: dict):
    return load_module(BENCH / "models" / f"{config['family']}.py")


def as_run(config: dict) -> dict:
    """The configuration as the program runs it: the published keys with
    each departure's ``as_run`` value in their place (what the plain
    reference is given)."""
    out = dict(config)
    out.update({k: d["as_run"] for k, d in config["departures"].items()
                if "as_run" in d})
    return out


def mode_module(traffic: dict):
    return load_module(BENCH / "modes" / f"{traffic['mode']}.py")


def reader_module(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py")


def kernel_names(kernel: str) -> dict:
    return load_json(BENCH / "kernels" / f"{kernel}.json")


def port_arch_config(config: dict):
    """The port's registered config of ``config["arch"]`` with the fields
    of ``config["port"]`` replaced (a dict replaces fields of a
    sub-config): the configuration as the program is told to run it."""
    from repro_torch.configs.base import get_config

    base = get_config(config["arch"])
    fields = {}
    for k, v in config["port"].items():
        cur = getattr(base, k)
        fields[k] = dataclasses.replace(cur, **v) if isinstance(v, dict) else v
    return dataclasses.replace(base, **fields)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules
                  if n.split(".", 1)[0] in FORBIDDEN_MODULES)


# -- what the benchmark makes from the seed ----------------------------------

def tree_items(tree, prefix: str = ""):
    """(name, leaf) of a tree of dicts and lists, names joined by dots."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of draws from ``seed``."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1])) & (2**63 - 1)


def tree_rebuild(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(name)``."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(v, fn, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1])


def make_weights(ctx, leaves, rule: Callable):
    """Named weights drawn from ``seed``: one buffer for the bf16 leaves
    and one for the float32 ones, each filled by ``normal_`` calls of
    WEIGHT_CHUNK values, in order of name, each leaf a
    view of its call's buffer scaled by ``rule(name, shape)``.  ``leaves``:
    (name, shape, dtype).  The same seed gives the same values on a device
    type."""
    torch, device = ctx.torch, ctx.device
    gen = torch.Generator(device=device).manual_seed(derived_seed(ctx.seed,
                                                                  2))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        group = sorted((n, tuple(s)) for n, s, d in leaves if d == dtype)
        total = sum(int(np.prod(s)) for _, s in group)
        if not total:
            continue
        flat = torch.empty(total, device=device, dtype=dtype)
        for lo in range(0, total, WEIGHT_CHUNK):
            flat[lo:lo + WEIGHT_CHUNK].normal_(generator=gen)
        off = 0
        for name, shape in group:
            size = int(np.prod(shape))
            view = flat[off:off + size].view(shape)
            kind, scale = rule(name, shape)
            if kind == "norm_scale":
                view.mul_(scale).add_(1.0)
            else:
                view.mul_(scale)
            out[name] = view
            off += size
    return out


def token_rows(seed: int, stream: int, index: int, rows: int, length: int,
               vocab: int) -> np.ndarray:
    """``rows`` x ``length`` token ids, uniform over the vocabulary, a pure
    function of (seed, stream, index)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), stream,
                                                        index]))
    return rng.integers(0, vocab, size=(rows, length), dtype=np.int64)


class ServiceDraws:
    """Each step's per-worker service times of the straggler model: shifted
    exponential (``delta + E / mu``) per unit of data, times each worker's
    load, a persistent slowdown on the named workers; one standard
    exponential a worker a step from ``(seed, stream)``."""

    def __init__(self, seed: int, service: dict, n_workers: int,
                 stream: int = 1):
        if service["dist"] != "sexp":
            raise ValueError(f"unknown service {service['dist']!r}")
        self.delta, self.mu = service["delta"], service["mu"]
        self.slow = {int(k): v for k, v in service.get("slow", {}).items()}
        self.n = n_workers
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                                 stream]))
        self.step = 0

    def next_step(self, loads=None) -> np.ndarray:
        loads = np.ones(self.n) if loads is None else np.asarray(loads, float)
        unit = self.rng.standard_exponential(self.n)
        times = (self.delta + unit / self.mu) * loads
        for w, factor in self.slow.items():
            times[w] *= factor
        self.step += 1
        return times


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    return float(statistics.quantiles(v, n=100, method="inclusive")[
        int(round(q * 100)) - 1])


# -- the profiler's trace ----------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """The events of a profiled sub-window, times in microseconds."""

    window: tuple[float, float]  # the harness's "bench.profiled" span
    device: list  # (name, start, end, correlation) of device operations
    launches: list  # (tid, start, end, correlation) of runtime calls
    host: list  # (tid, name, start, end) of host ops and annotations
    main_tid: Any = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device-operation intervals inside the window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device
                     if e > lo and s < hi)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, pattern: re.Pattern) -> float:
        return sum(e - s for n, s, e, _ in self.device
                   if pattern.search(n)) * 1e-6

    def spans(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for tid, n, s, e in self.host
                if n == name and tid == self.main_tid]

    def span_device_seconds(self, name: str) -> float:
        """Device time of the operations launched inside the host spans
        ``name``, matched through the runtime's launch correlation."""
        spans = self.spans(name)
        corr = {c for tid, s, e, c in self.launches
                if tid == self.main_tid and any(a <= s and e <= b
                                                for a, b in spans)}
        return sum(e - s for _, s, e, c in self.device if c in corr) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        tot: dict[str, float] = {}
        for name, s, e, _ in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest idle gaps of the device inside the window, each
        named by the host spans open at its middle (outermost / innermost),
        or, where only the window is, by the host ops either side of it."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            main = [(hs, he, name) for tid, name, hs, he in self.host
                    if tid == self.main_tid and name != "bench.profiled"]
            open_ = sorted((h for h in main if h[0] <= mid <= h[1]),
                           key=lambda h: h[0] - h[1])
            if len(open_) == 1:
                label = open_[0][2]
            elif open_:
                label = f"{open_[0][2]} / {open_[-1][2]}"
            else:
                before = max((h for h in main if h[1] < mid),
                             key=lambda h: h[1], default=None)
                after = min((h for h in main if h[0] > mid),
                            key=lambda h: h[0], default=None)
                label = (f"between {before[2] if before else 'start'} and "
                         f"{after[2] if after else 'end'}")
            out.append([_short(label), (e - s) * 1e-6])
        return out


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def read_trace(path: str) -> Trace:
    data = load_json(Path(path))
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    device, launches, host = [], [], []
    window, main_tid = None, None
    for ev in events:
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev["dur"])
        args = ev.get("args", {})
        if cat in DEVICE_CATS:
            device.append((ev["name"], ts, ts + dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches.append((ev.get("tid"), ts, ts + dur,
                             args.get("correlation")))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((ev.get("tid"), ev["name"], ts, ts + dur))
            if ev["name"] == "bench.profiled":
                window, main_tid = (ts, ts + dur), ev.get("tid")
    if window is None:
        raise RuntimeError("the trace holds no bench.profiled span")
    return Trace(window, device, launches, host, main_tid)


def synchronize(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


class Profiled:
    """``torch.profiler`` over a sub-window, entered once and left once;
    the trace goes to a file under ``TMPDIR`` that is read and deleted on
    leaving."""

    def __init__(self, torch, device: str):
        self.torch, self.device = torch, device
        self.prof = None
        self.span = None
        self.trace: Optional[Trace] = None

    def warm(self):
        """One short session in set-up, so that the tracer's own start-up
        (seconds, the first time in a process) is not inside the window."""
        t = self.torch
        acts = [t.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(t.profiler.ProfilerActivity.CUDA)
        with t.profiler.profile(activities=acts):
            t.ones(8, device=self.device).sum()
        synchronize(t, self.device)

    def start(self):
        t = self.torch
        synchronize(t, self.device)
        acts = [t.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(t.profiler.ProfilerActivity.CUDA)
        self.prof = t.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = t.profiler.record_function("bench.profiled")
        self.span.__enter__()

    def stop(self):
        synchronize(self.torch, self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = read_trace(path)
        finally:
            os.unlink(path)
        self.prof = None


# -- a run -------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a mode is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter at process start
    torch: Any
    log: Callable = print
    control: bool = False  # also read the control's numbers (calibration)


@dataclasses.dataclass
class Outcome:
    """What a mode returns."""

    end_to_end: dict  # metric name -> value
    attempted: int
    failed: int
    checks: list  # (name, value, limit): value <= limit passes
    memory_peak_bytes: int
    readings: dict  # what the per-layer readers read
    trace: Optional[Trace] = None
    control: Optional[dict] = None  # the control's numbers, where asked


def device_record(torch, device: str, peak: int,
                  trace: Optional[Trace]) -> dict:
    if device == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace.busy_s()
        rec["window_s"] = trace.window_s
    return rec


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the cell, the mode's numbers and the
    traced sub-window."""

    cell: Cell
    values: dict
    trace: Optional[Trace]


def per_layer_metrics(cell: Cell, outcome: Outcome) -> dict:
    r = Readings(cell, outcome.readings, outcome.trace)
    out = {}
    for m in cell.per_layer:
        value = reader_module(m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, log=None) -> dict:
    """Runs one cell once and returns its result line as a dict (the
    checks last)."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = load_cell(root, cell_name)
    ctx = Context(cell, seed, seconds, trace, device, t_start, torch, log)
    outcome = mode_module(cell.traffic).run(ctx)
    if trace:
        metrics = per_layer_metrics(cell, outcome)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    checks = {name: {"value": float(v), "limit": float(lim)}
              for name, v, lim in outcome.checks}
    correct = (outcome.attempted > 0 and outcome.failed == 0
               and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": device_record(torch, device, outcome.memory_peak_bytes,
                                outcome.trace),
    }
    if trace and outcome.trace is not None:
        result["breakdown"] = {"device_ops": outcome.trace.top_device_ops(),
                               "idle_gaps": outcome.trace.idle_gaps()}
    result["checks"] = checks
    return result


# -- what per-layer readers share ---------------------------------------------

def model_flops_share(r: Readings) -> Optional[float]:
    """Model FLOPs over (seconds x the bf16 peak), in %, over the part of a
    traced window before its profiled sub-window."""
    v = r.values
    if not v.get("model_seconds"):
        return None
    from yardstick import PEAK_BF16_FLOPS

    return 100.0 * v["model_flops"] / (v["model_seconds"] * PEAK_BF16_FLOPS)


def roofline_share(r: Readings, kernel: str) -> Optional[float]:
    """The least time the chip could take for the calls of ``kernel`` in the
    profiled sub-window (the yardstick's work at each call's shape), over
    the device time of the kernels ``kernels/<kernel>.json`` names, in %."""
    calls = r.values.get("kernel_calls", {}).get(kernel)
    if r.trace is None or not calls:
        return None
    import yardstick as Y

    names = kernel_names(kernel)
    pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        map(re.escape, names["kernels"])) + r")(?![A-Za-z0-9_])")
    device_s = r.trace.device_seconds(pattern)
    if device_s <= 0:
        return None
    work, grad_work = getattr(Y, names["work"]), getattr(Y, names["grad_work"])
    bound = 0.0
    for c in calls:
        shape = {k: c[k] for k in ("b", "sq", "skv", "h", "kv", "d", "causal")}
        one = Y.bound_seconds(*work(**shape))
        if c["grad"]:
            one += Y.bound_seconds(*grad_work(**shape))
        bound += c["count"] * one
    return 100.0 * bound / device_s


def idle_share(r: Readings) -> Optional[float]:
    """The share of the profiled sub-window in which no device operation
    ran, in %."""
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
