#!/usr/bin/env python3
"""Times the unstaged ``sojourn_cells`` kernel against a parent tree's, on
one card, at the shapes ``PERF.md`` tracks it at.

    python3 sojourn_wide_ab.py [--parent DIR] [--reps N]

``DIR`` is a checkout of the parent commit (for example ``git archive``
unpacked under ``build/``); its ``csrc/sojourn_cells.cu`` is compiled with
this tree's flags beside this tree's library and called through its own C
interface (the parent's ``sojourn_cells_wide_launch`` has no split).  The
shapes (cells, jobs, sets, policies):

* ``WIDE_FLEET``: the one dispatch of ``chip_smoke.py`` phase 2b's plan
  (N 16,384, B 2,048 to 16,384, 4,000 trials): 4, 4,000, 16,384, 4;
* ``check``: phase 2b's row at 65,536 sets: 1, 1,000, 65,536, 4;
* ``plan_policies``: phase 2's dispatch (N 10,000, B 50 to 2,000, 20,000
  trials), 6, 20,000, 2,000, 4, on the unstaged kernel (forced) and on the
  staged one.

Each is timed in turns parent, change, change, parent (CUDA events, the
median of ``reps`` calls each turn), the change also with as little of
the sets' state in shared memory as its instantiation takes (the tables'
``kh = kc = 0``; where the lanes keep the nodes in registers, every hot
word stays on chip and ``kc = 0``), and every kernel's output is held
bit-equal to this tree's own.  Prints one JSON line and writes it to
``chiprun_out/sojourn_wide_ab.json``.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _parent_lib(parent: Path):
    """The parent's sojourn_cells.cu, built with this tree's flags."""
    from repro_torch.kernels import _build

    src = parent / "src" / "repro_torch" / "csrc" / "sojourn_cells.cu"
    out = _build.BUILD_DIR / "ab" / "libsojourn_cells_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [_build._nvcc(), *_build._flags("sojourn_cells"), "-Xptxas", "-v",
         "-o", str(out), str(src)], check=True, capture_output=True,
        text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.ptxas_log = log.stdout + log.stderr
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sojourn_cells_wide_launch.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.sojourn_cells_wide_launch.restype = i
    lib.sojourn_cells_launch.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.sojourn_cells_launch.restype = i
    lib.sojourn_cells_state_words.argtypes = [i]
    lib.sojourn_cells_state_words.restype = ctypes.c_longlong
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.core.order_stats import ShiftedExponential
    from repro_torch.core.planner import ClusterSpec, Objective, SimulatedPlanner
    from repro_torch.core.policies import PolicyCandidate
    from repro_torch.kernels import _build
    from repro_torch.kernels.sojourn_sweep import kernel as SK
    from repro_torch.kernels.sojourn_sweep import ops as SOPS

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    lib = _build.load("sojourn_cells")
    parent = _parent_lib(args.parent) if args.parent else None

    policies = (PolicyCandidate("none"),
                PolicyCandidate("clone", quantile=0.85),
                PolicyCandidate("relaunch", quantile=0.9),
                PolicyCandidate("hedged", hedge_fraction=0.3))
    heavy = ShiftedExponential(0.05, 2.0)
    objective = Objective(metric="p99", utilization=0.7, policies=policies)

    def dispatch(n, feasible, trials):
        calls = []
        orig = SK.sojourn_cells

        def wrapped(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)

        SK.sojourn_cells = wrapped
        try:
            SimulatedPlanner(n_trials=trials, seed=0, device="cuda").plan(
                ClusterSpec(n_workers=n, dist=heavy, feasible_b=feasible),
                objective)
        finally:
            SK.sojourn_cells = orig
        (a, kw), = calls
        return a, bool(kw.get("resolve", True))

    def check_cells(n_jobs, n_g):
        g = torch.Generator(device=dev).manual_seed(n_g)
        arr = torch.cumsum(torch.empty(n_jobs, device=dev).exponential_(
            1.0, generator=g) * (1.6 / n_g), 0)
        svc, alt = (torch.empty(1, n_jobs, n_g, device=dev).exponential_(
            1.0, generator=g) + 0.1 for _ in range(2))
        kinds = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
        thr = torch.tensor([[math.inf, 1.2, 1.9, math.inf]], device=dev)
        hm = torch.as_tensor(np.stack(
            [SOPS.hedge_mask(n_jobs, f) for f in (0, 0, 0, 0.3)])).to(dev)
        ng = torch.tensor([n_g], dtype=torch.int32, device=dev)
        return (arr, svc, alt, kinds, thr, hm, ng), True

    shapes = {
        "WIDE_FLEET": dispatch(CS.WIDE_FLEET_N, CS.WIDE_FLEET_B,
                               CS.WIDE_FLEET_TRIALS),
        "check": check_cells(CS.WIDE_CHECK_JOBS, CS.WIDE_CHECK_GROUPS[-1]),
        "plan_policies": dispatch(10_000, (50, 100, 200, 500, 1000, 2000),
                                  20_000),
    }

    def ptrs(a, out, extra):
        return [ctypes.c_void_p(t.data_ptr()) for t in (
            a[0], a[1], a[2], a[3], a[4], a[5].view(torch.uint8), a[6], out,
            extra)]

    def runner(a, resolve, which, split=None):
        """A call of one kernel on the shape's inputs: (out, extra)."""
        n_cells, n_jobs, n_g = a[1].shape
        n_pol = a[3].shape[0]
        out = torch.empty((n_cells, n_pol, n_jobs), device=dev)
        extra = torch.empty((n_cells, n_pol), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if which == "staged":
            return lambda: SK.sojourn_cells(*a, resolve=resolve)
        if which == "parent_staged":
            def call():
                code = parent.sojourn_cells_launch(
                    *ptrs(a, out, extra), n_cells, n_pol, n_jobs, n_g,
                    int(resolve), stream)
                assert code == 0, code
                return out, extra
            return call
        if which == "parent":
            words = parent.sojourn_cells_state_words(n_g)
            state = torch.empty(n_cells * n_pol * words, device=dev)

            def call():
                code = parent.sojourn_cells_wide_launch(
                    *ptrs(a, out, extra), ctypes.c_void_p(state.data_ptr()),
                    n_cells, n_pol, n_jobs, n_g, int(resolve), stream)
                assert code == 0, code
                return out, extra
            return call
        kh, kc = split if split is not None else SK._wide_split(n_g)
        words = lib.sojourn_cells_state_words(n_g, kh, kc)
        state = torch.empty(max(n_cells * n_pol * words, 1), device=dev)

        def call():
            code = lib.sojourn_cells_wide_launch(
                *ptrs(a, out, extra), ctypes.c_void_p(state.data_ptr()),
                n_cells, n_pol, n_jobs, n_g, int(resolve), kh, kc, stream)
            assert code == 0, code
            return out, extra
        return call

    def time_ms(fn, reps):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in pairs:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    report = {"card": card, "shapes": {}}
    for name, (a, resolve) in shapes.items():
        n_g = a[1].shape[2]
        ref = SK.sojourn_cells(*a, resolve=resolve, force_wide=True)
        # the split's lever: no set word in shared memory past the tables
        # (where the lanes keep the nodes in registers, every set's hot
        # words stay on chip, so only the cold ones leave)
        gp = -(-n_g // 128) * 128
        regs = -(-(gp // 128) // 32) <= 4
        fns = {"change": runner(a, resolve, "change"),
               "change_unstaged_state": runner(
                   a, resolve, "change", (gp if regs else 0, 0))}
        if parent is not None:
            fns["parent"] = runner(a, resolve, "parent")
        if name == "plan_policies":
            fns["staged"] = runner(a, resolve, "staged")
            if parent is not None:
                fns["parent_staged"] = runner(a, resolve, "parent_staged")
        for tag, fn in fns.items():
            got = fn()
            if not all(torch.equal(u, v) for u, v in zip(got, ref)):
                raise AssertionError(f"{name}: {tag} differs from this "
                                     f"tree's unstaged kernel")
        # in turns: A B B A over every kernel of the shape
        order = list(fns) + list(reversed(fns))
        times: dict = {t: [] for t in fns}
        for tag in order:
            times[tag].append(time_ms(fns[tag], args.reps))
        row = {"shape": [int(v) for v in a[1].shape] + [int(a[3].shape[0])],
               "split": list(SK._wide_split(n_g)),
               "ms": {t: v for t, v in times.items()},
               "per_job_us": {t: statistics.mean(v) / a[1].shape[1] * 1e3
                              for t, v in times.items()}}
        report["shapes"][name] = row
        print(f"[ab] {name} {row['shape']} split {row['split']}: " + ", ".join(
            f"{t} {' / '.join(f'{x:.3f}' for x in v)} ms"
            for t, v in times.items()), flush=True)
        del ref, fns
        torch.cuda.empty_cache()
    report["ptxas"] = CS.soj_ptxas_figures()
    if parent is not None:
        report["ptxas_parent"] = CS.soj_ptxas_figures(parent.ptxas_log)
    print(f"[ab] ptxas: {report['ptxas']}; parent's "
          f"{report.get('ptxas_parent')} on {card}")
    out = ROOT / "chiprun_out" / "sojourn_wide_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
