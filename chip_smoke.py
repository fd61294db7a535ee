#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — ``ClusterSpec`` + ``Objective`` ->
``SimulatedPlanner.plan()`` -> ``Plan`` — on the card through its three
hand-written CUDA kernels, in five phases; any failure raises and the
script exits non-zero:

1. ``build``          compile ``src/repro_torch/csrc/*.cu`` with nvcc
                      (one process per source, in parallel) into
                      ``build/repro_torch_kernels/``.
2. ``plan_policies``  the fleet's planner call: N=10,000 workers,
                      20,000 jobs, B in {50..2000}, four straggler
                      policies, p99 at utilization 0.7.  Then a small plan
                      run on the card and on the CPU (the kernels' plain
                      versions) must agree exactly.
3. ``fleet_grid``     ``sweep_sojourn_policies`` on the bootstrap grid of
                      ``benchmarks/bench_sweep_kernel.py``: 256 Empirical
                      resamples x B in {50, 100, 200} x 4 policies, J=300.
4. ``plan_coded``     the coded headline of ``benchmarks/bench_coding.py``
                      (mds s in {4, 8, 12}, overheads measured by the
                      ``combine`` kernel); the winner must be mds(s=12).
                      Then the same candidates under a load-aware p99.
5. ``kernels``        each kernel against its plain PyTorch version on the
                      card, at the shapes phases 2 and 4 gave it, with its
                      time, the plain version's, a library call's where one
                      exists, and its bound.

Each path of phases 2-4 runs with the launch counts and the sweeps' stage
seconds (``simulator.STAGE_SECONDS``) set to 0 just before it and read just
after; a kernel of the path that never launched fails the run.  One more
run of phases 2 and 3 under ``torch.profiler`` gives the card's busy time.
The last lines are the card (``nvidia-smi`` name and power limit), one
JSON object of kernels, and one JSON object ``{"ok": true, "device": ...}``.
Details go to ``chiprun_out/chip_smoke.json``.  The script exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SOJOURN_PLAIN_JOBS = 2_000


def _fail(msg: str, code: int) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def main() -> int:
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        _fail("src/repro_torch not found next to this script: run it from "
              "a checkout of the repository", 2)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device is visible (torch.cuda.is_available() is "
              "False); the port's smoke run needs one GPU", 1)
    sys.path.insert(0, src)
    import numpy as np

    from repro_torch.core.coding import CodingCandidate
    from repro_torch.core.order_stats import Empirical, ShiftedExponential
    from repro_torch.core.planner import ClusterSpec, Objective, SimulatedPlanner
    from repro_torch.core.policies import PolicyCandidate
    from repro_torch.core import simulator as SIM
    from repro_torch.core.simulator import sweep_sojourn_policies
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded import kernel as CK
    from repro_torch.kernels.coded import ops as coded_ops
    from repro_torch.kernels.sojourn_sweep import kernel as SK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report: dict = {"phases": {}}
    path_counts: dict = {}  # path -> {kernel: launches in that path's run}

    def timed_stages(fn):
        """(result, wall s, stage s) of one call, counts and stages at 0."""
        _build.reset_launch_counts()
        SIM.reset_stage_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = dict(SIM.STAGE_SECONDS)
        stages["rest"] = wall - sum(stages.values())
        return res, wall, stages

    def run_path(name: str, fn):
        """Drive one path of the main path; return (result, counts, wall,
        stage seconds)."""
        res, wall, stages = timed_stages(fn)
        counts = _build.launch_counts()
        path_counts[name] = counts
        print(f"[{name}] wall {wall:.3f} s, launches {counts}", flush=True)
        print(f"[{name}] stages (host s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        return res, counts, wall, stages

    def capture(module, attr, sink):
        orig = getattr(module, attr)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            sink.append((args, kw))
            return out

        setattr(module, attr, wrapped)
        return orig

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def nbytes(*tensors) -> int:
        seen, total = set(), 0
        for t in tensors:
            if t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
        return total

    def device_busy(fn):
        """(wall s, busy s, device events) of one call under torch.profiler.

        Busy is the union of the intervals of the device's own events
        (kernels and copies), so nothing is counted twice; None when the
        profiler recorded no device event."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
        busy_us, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_us += cur_e - cur_s
        busy = busy_us / 1e6 if spans else None
        return wall, busy, len(spans)

    def print_busy(name, wall, busy, n_events):
        idle = None if busy is None else 1.0 - busy / wall
        print(f"[{name}] under torch.profiler: wall {wall:.3f} s, device "
              f"busy {busy} s over {n_events} device events, idle share "
              f"{idle}")
        return {"profiled_wall_s": wall, "device_busy_s": busy,
                "device_events": n_events, "idle_share": idle}

    # -- 1. build ---------------------------------------------------------
    _phase("build")
    card = _card_line()
    t0 = time.perf_counter()
    secs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.2f} s wall, per kernel {secs}")
    print(f"[build] card: {card}")
    print(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    report["card"] = card
    report["phases"]["build"] = {"seconds": build_s, "per_kernel": secs}

    # -- 2. plan_policies -------------------------------------------------
    _phase("plan_policies")
    policies = (PolicyCandidate("none"),
                PolicyCandidate("clone", quantile=0.85),
                PolicyCandidate("relaunch", quantile=0.9),
                PolicyCandidate("hedged", hedge_fraction=0.3))
    heavy = ShiftedExponential(0.05, 2.0)
    spec = ClusterSpec(n_workers=10_000, dist=heavy,
                       feasible_b=(50, 100, 200, 500, 1000, 2000))
    objective = Objective(metric="p99", utilization=0.7, policies=policies)

    def fleet_plan():
        return SimulatedPlanner(n_trials=20_000, seed=0, device="cuda").plan(
            spec, objective)

    soj_calls: list = []
    orig = capture(SK, "sojourn_cells", soj_calls)
    try:
        plan, counts, wall, stages = run_path("plan_policies", fleet_plan)
    finally:
        SK.sojourn_cells = orig
    if counts["sojourn_cells"] <= 0:
        raise AssertionError("plan_policies never launched sojourn_cells")
    pts = plan.spectrum.points
    if not all(np.isfinite([p.mean, p.var, p.p99, p.p999]).all() for p in pts):
        raise AssertionError("non-finite spectrum point")
    if plan.n_batches not in spec.feasible_batches() or plan.backend != "cuda":
        raise AssertionError(f"bad plan {plan.n_batches} {plan.backend}")
    print(f"[plan_policies] B={plan.n_batches} policy={plan.policy} "
          f"p99={plan.predicted.p99:.6f} backend={plan.backend}")
    for p in pts:
        print(f"    B={p.n_batches:5d} mean={p.mean:.6f} p99={p.p99:.6f}")
    # the card's busy time on a re-plan (its group minima come from the
    # cache the first run filled)
    busy = print_busy("plan_policies", *device_busy(fleet_plan))

    # the card's plan equals the CPU plan (plain versions) on a small fleet;
    # a check, not part of the path, so its launches are not counted
    small = ClusterSpec(n_workers=16, dist=heavy, feasible_b=(2, 4, 8))
    plans = {d: SimulatedPlanner(n_trials=400, seed=0, device=d).plan(
        small, objective) for d in ("cuda", "cpu")}
    same = all(
        (a.mean, a.var, a.p99, a.p999) == (b.mean, b.var, b.p99, b.p999)
        for a, b in zip(plans["cuda"].spectrum.points,
                        plans["cpu"].spectrum.points))
    if not same or plans["cuda"].policy != plans["cpu"].policy:
        raise AssertionError("small plan differs between the card and the CPU")
    print(f"[plan_policies] small fleet: card plan == CPU plan "
          f"(B={plans['cuda'].n_batches}, policy={plans['cuda'].policy})")
    report["phases"]["plan_policies"] = {
        "wall_s": wall, "stages_s": stages, "launches": counts,
        "n_batches": plan.n_batches, "policy": repr(plan.policy),
        "points": [[p.n_batches, p.mean, p.var, p.p99, p.p999] for p in pts],
        "sojourn_dispatches": [
            {"cells": int(a[1].shape[0]), "policies": int(a[3].shape[0]),
             "jobs": int(a[1].shape[1]), "groups": int(a[1].shape[2]),
             "resolve": bool(kw.get("resolve", True))}
            for a, kw in soj_calls],
        "small_plan_card_equals_cpu": same, **busy,
    }

    # -- 3. fleet_grid ----------------------------------------------------
    _phase("fleet_grid")
    rng = np.random.default_rng(0)
    pool = rng.gamma(2.0, 0.5, 10_000)
    dists = [Empirical(rng.choice(pool, pool.size)) for _ in range(256)]

    def fleet():
        return sweep_sojourn_policies(
            dists, n_workers=10_000, arrival_rate=40.0, policies=policies,
            n_jobs=300, seed=3, feasible_b=[50, 100, 200], device="cuda")

    res, counts, cold, _ = run_path("fleet_grid", fleet)
    if counts["sojourn_cells"] <= 0:
        raise AssertionError("fleet_grid never launched sojourn_cells")
    if res.samples.shape != (256, 3, 4, 270) or not np.isfinite(
            res.samples).all():
        raise AssertionError(f"bad fleet samples {res.samples.shape}")
    warm = [timed_stages(fleet)[1:] for _ in range(3)]
    best_wall, best_stages = min(warm, key=lambda w: w[0])
    print(f"[fleet_grid] 3072 (cell, policy) programs: cold {cold:.3f} s, "
          f"warm best-of-3 {best_wall:.3f} s (all "
          f"{[round(w[0], 4) for w in warm]})")
    print("[fleet_grid] best warm run's stages (host s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in best_stages.items()))
    busy = print_busy("fleet_grid", *device_busy(fleet))
    report["phases"]["fleet_grid"] = {
        "cold_s": cold, "warm_s": [w[0] for w in warm],
        "warm_stages_s": best_stages, "launches": counts, **busy}

    # -- 4. plan_coded ----------------------------------------------------
    _phase("plan_coded")
    cands = tuple(CodingCandidate("mds", s) for s in (4, 8, 12))
    coded_calls: list = []
    combine_calls: list = []
    o1 = capture(SK, "coded_cells", coded_calls)
    o2 = capture(coded_ops, "combine", combine_calls)
    try:
        cplan, counts, wall, _ = run_path(
            "plan_coded", lambda: SimulatedPlanner(
                n_trials=6_000, seed=0, device="cuda").plan(
                    ClusterSpec(n_workers=16, dist=heavy),
                    Objective(metric="mean", coding=cands)))
        if cplan.coding is None or cplan.coding.describe() != "mds(s=12)":
            raise AssertionError(f"coded winner {cplan.coding}, want mds(s=12)")
        best_rep = min(p.mean for p in cplan.spectrum.points)
        print(f"[plan_coded] winner {cplan.coding.describe()} "
              f"mean={cplan.predicted.mean:.6f} vs best replication "
              f"{best_rep:.6f}; enc={cplan.coding.encode_overhead:.3e} s "
              f"dec={cplan.coding.decode_overhead:.3e} s")
        for k in ("combine", "coded_cells"):
            if counts[k] <= 0:
                raise AssertionError(f"plan_coded never launched {k}")
        lplan, lcounts, lwall, _ = run_path(
            "plan_coded_sojourn", lambda: SimulatedPlanner(
                n_trials=6_000, seed=0, device="cuda").plan(
                    ClusterSpec(n_workers=16, dist=heavy),
                    Objective(metric="p99", utilization=0.7, coding=cands)))
        for k in _build.SOURCES:
            if lcounts[k] <= 0:
                raise AssertionError(f"plan_coded_sojourn never launched {k}")
    finally:
        SK.coded_cells, coded_ops.combine = o1, o2
    print(f"[plan_coded] load-aware p99: B={lplan.n_batches} "
          f"coding={lplan.coding} p99={lplan.predicted.p99:.6f}")
    report["phases"]["plan_coded"] = {
        "wall_s": wall, "launches": counts, "winner": cplan.coding.describe(),
        "mean": cplan.predicted.mean, "best_replication_mean": best_rep,
        "encode_s": cplan.coding.encode_overhead,
        "decode_s": cplan.coding.decode_overhead,
        "sojourn_wall_s": lwall, "sojourn_launches": lcounts,
        "sojourn_plan": [lplan.n_batches, repr(lplan.coding),
                         lplan.predicted.p99],
    }

    def launches(kernel: str, home: str) -> dict:
        """The kernel's launches on the path whose shapes its row times
        (``launches``) and on every path (``launches_by_path``)."""
        return {"launches": path_counts[home][kernel], "launches_path": home,
                "launches_by_path": {p: c[kernel]
                                     for p, c in path_counts.items()}}

    # -- 5. kernels -------------------------------------------------------
    _phase("kernels")

    rows = []
    extra_rows = []

    # sojourn_cells: the largest trigger and trigger-free dispatches of
    # plan_policies, held bit-equal to the plain version on their first
    # SOJOURN_PLAIN_JOBS jobs (the plain version loops over jobs in Python)
    by_family = {}
    for args, kw in soj_calls:
        fam = bool(kw.get("resolve", True))
        if fam not in by_family or args[1].shape[2] > by_family[fam][0][1].shape[2]:
            by_family[fam] = (args, kw)
    soj_entries = []
    for fam in (True, False):
        if fam not in by_family:
            continue
        args, kw = by_family[fam]
        arr, svc, alt, kinds, thr, hm, ng = args
        out_k, x_k = SK.sojourn_cells(*args, **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: SK.sojourn_cells(*args, **kw), 3)
        j = min(SOJOURN_PLAIN_JOBS, svc.shape[1])
        cut = (arr[:j].contiguous(), svc[:, :j].contiguous(),
               alt[:, :j].contiguous(), kinds, thr, hm[:, :j].contiguous(), ng)
        out_c, x_c = SK.sojourn_cells(*cut, **kw)
        ms_cut = cuda_ms(lambda: SK.sojourn_cells(*cut, **kw), 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, x_p = SK.sojourn_cells_plain(*cut, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(out_c, out_p) and torch.equal(x_c, x_p)):
            diff = (out_c - out_p).abs().max().item()
            raise AssertionError(
                f"sojourn_cells differs from its plain version (resolve="
                f"{fam}): max |diff| {diff}")
        if not torch.isfinite(out_k).all():
            raise AssertionError("sojourn_cells produced non-finite sojourns")
        bound_ms = nbytes(*args, out_k, x_k) / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": "sojourn_cells", "resolve": fam,
            "shape": [int(s) for s in svc.shape] + [int(kinds.shape[0])],
            "ms": ms, "ms_at_plain_jobs": ms_cut, "plain_jobs": j,
            "plain_ms": plain_ms, "max_abs_err": 0.0, "bound_ms": bound_ms,
            "library_ms": None,
        }
        soj_entries.append(entry)
        print(f"[kernels] sojourn_cells resolve={fam} C,J,G,P={entry['shape']}"
              f": {ms:.3f} ms (first {j} jobs: kernel {ms_cut:.3f} ms, plain "
              f"{plain_ms:.1f} ms, bit-equal), bound {bound_ms:.4f} ms")
    head = soj_entries[0]
    rows.append({"name": "sojourn_cells", "route": "cuda",
                 "source": "src/repro_torch/csrc/sojourn_cells.cu",
                 "replaces": "src/repro/kernels/sojourn_sweep/kernel.py:216",
                 **launches("sojourn_cells", "plan_policies"),
                 "max_abs_err": 0.0, "ms": head["ms"],
                 "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                 "bound_by": "bytes", "library_ms": None,
                 "shape": head["shape"], "plain_jobs": head["plain_jobs"],
                 "ms_at_plain_jobs": head["ms_at_plain_jobs"]})
    extra_rows.extend(soj_entries)

    # coded_cells: the planner's shape, then long rows with duplicates
    def coded_row(times, ks, reps):
        out_k = SK.coded_cells(times, ks)
        out_p = SK.coded_cells_plain(times, ks)
        if not torch.equal(out_k, out_p):
            raise AssertionError(
                f"coded_cells differs from its plain version at "
                f"{tuple(times.shape)}")
        ms = cuda_ms(lambda: SK.coded_cells(times, ks), reps)
        plain_ms = cuda_ms(lambda: SK.coded_cells_plain(times, ks), reps)
        ks_host = ks.tolist()
        lib_ms = cuda_ms(lambda: [torch.kthvalue(times[c], ks_host[c], dim=1)
                                  for c in range(times.shape[0])], reps)
        bound_ms = nbytes(times, ks, out_k) / HBM_BYTES_PER_S * 1e3
        entry = {"name": "coded_cells", "shape": list(times.shape), "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "max_abs_err": 0.0}
        if times.shape[2] <= 64:
            # the same rows through the long-row radix path
            if not torch.equal(SK.coded_cells(times, ks, force_radix=True),
                               out_p):
                raise AssertionError("coded_cells radix path differs")
            entry["radix_ms"] = cuda_ms(
                lambda: SK.coded_cells(times, ks, force_radix=True), reps)
        return entry

    planner_times = max(coded_calls, key=lambda c: c[0][0].numel())[0]
    e_plan = coded_row(*planner_times, reps=50)
    g = torch.Generator(device="cpu").manual_seed(7)
    big = torch.empty((2, 2000, 10_000)).exponential_(generator=g)
    big[:, :, ::7] = big[:, :, 1::7][:, :, : big[:, :, ::7].shape[2]]  # dups
    big = big.to(dev).contiguous()
    e_big = coded_row(big, torch.tensor([9000, 9988], dtype=torch.int32,
                                        device=dev), reps=10)
    for e in (e_plan, e_big):
        radix = (f" (radix path on the same rows {e['radix_ms']:.4f} ms)"
                 if "radix_ms" in e else "")
        print(f"[kernels] coded_cells {e['shape']}: {e['ms']:.4f} ms{radix}, "
              f"plain {e['plain_ms']:.4f} ms, kthvalue {e['library_ms']:.4f} "
              f"ms, bound {e['bound_ms']:.5f} ms, bit-equal")
    rows.append({"name": "coded_cells", "route": "cuda",
                 "source": "src/repro_torch/csrc/coded_cells.cu",
                 "replaces": "src/repro/kernels/sojourn_sweep/kernel.py:183",
                 **launches("coded_cells", "plan_coded"), "max_abs_err": 0.0,
                 "ms": e_plan["ms"], "plain_ms": e_plan["plain_ms"],
                 "bound_ms": e_plan["bound_ms"], "bound_by": "bytes",
                 "library_ms": e_plan["library_ms"], "shape": e_plan["shape"],
                 "radix_ms": e_plan["radix_ms"]})
    extra_rows.extend([e_plan, e_big])

    # combine: the planner's largest encode, then a square-ish GEMM
    def combine_row(a, b, reps):
        out_k = CK.combine(a, b)
        out_p = CK.combine_plain(a, b)
        bound = CK.COMBINE_RTOL * (a.double().abs() @ b.double().abs())
        err = (out_k.double() - out_p.double()).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"combine outside its bound at {tuple(a.shape)}x"
                f"{tuple(b.shape)}: max err {err.max().item()}")
        ms = cuda_ms(lambda: CK.combine(a, b), reps)
        plain_ms = cuda_ms(lambda: CK.combine_plain(a, b), max(1, reps // 10))
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        r, k = a.shape
        d = b.shape[1]
        bound_ms = max(2.0 * r * k * d / FP32_FLOP_PER_S,
                       4.0 * (r * k + k * d + r * d) / HBM_BYTES_PER_S) * 1e3
        by = ("operations" if 2.0 * r * k * d / FP32_FLOP_PER_S
              > 4.0 * (r * k + k * d + r * d) / HBM_BYTES_PER_S else "bytes")
        return {"name": "combine", "shape": [r, k, d], "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": by,
                "max_abs_err": err.max().item()}

    planner_ab = max(combine_calls,
                     key=lambda c: c[0][0].numel() * c[0][1].shape[1])[0]
    c_plan = combine_row(*planner_ab, reps=100)
    gen = torch.Generator(device="cpu").manual_seed(11)
    a = torch.randn((1024, 1024), generator=gen).to(dev)
    b = torch.randn((1024, 2048), generator=gen).to(dev)
    c_big = combine_row(a, b, reps=10)
    for e in (c_plan, c_big):
        print(f"[kernels] combine {e['shape']}: {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, matmul {e['library_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']}), max err "
              f"{e['max_abs_err']:.3e}")
    rows.append({"name": "combine", "route": "cuda",
                 "source": "src/repro_torch/csrc/combine.cu",
                 "replaces": "src/repro/kernels/coded/kernel.py:35",
                 **launches("combine", "plan_coded"),
                 "max_abs_err": c_plan["max_abs_err"], "ms": c_plan["ms"],
                 "plain_ms": c_plan["plain_ms"], "bound_ms": c_plan["bound_ms"],
                 "bound_by": c_plan["bound_by"],
                 "library_ms": c_plan["library_ms"], "shape": c_plan["shape"]})
    extra_rows.extend([c_plan, c_big])

    report["kernels"] = rows
    report["kernel_shapes"] = extra_rows
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(f"[kernels] all shapes: {json.dumps(extra_rows)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
