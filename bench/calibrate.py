"""Readings that the limits of a cell's checks are set from, on the chip:
the program's numbers over many seeds, the control's (the float32
reference put in the program's place, computed in float8), and a planted
fault's.  Not part of a benchmark run.

    python3 bench/calibrate.py --workload olmoe.train --seconds 2 \\
        --seeds 101 102 ... --control 101 102 103 --fault 101 102 103 \\
        [--out FILE]

Each reading is one run of the cell's own mode, as ``bench/run.py`` makes
it, with a window of ``--seconds``: a training cell's start and its
settled steps after the window, a prefill cell's batches sampled among
the window's first ``check_span``.  The control is read in the same run,
from the same starting points and prompts.  The fault is each mode's:
half of each step's batch left out of the aggregation, the mean taken
over the rest (training); the served token altered (prefill).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness as H  # noqa: E402
import numpy as np  # noqa: E402


def half_batch_fault():
    """Plants the fault: each step aggregates only its first covered batch.
    Returns the undo."""
    import repro_torch.launch.train as TR

    orig = TR.aggregate_host

    def half(grads, alive, plan, worker_batch=None):
        first = min(worker_batch[w] for w, g in enumerate(grads)
                    if g is not None)
        kept = [g if g is not None and worker_batch[w] == first else None
                for w, g in enumerate(grads)]
        return orig(kept, np.array([g is not None for g in kept]), plan,
                    worker_batch=worker_batch)

    TR.aggregate_host = half
    return lambda: setattr(TR, "aggregate_host", orig)


def unchanged_state_fault():
    """Plants the fault: the optimizer step returns its state unchanged."""
    import repro_torch.launch.train as TR

    orig = TR.opt_update_
    TR.opt_update_ = lambda grad, state, params, lr, cfg: (params, state, {})
    return lambda: setattr(TR, "opt_update_", orig)


def altered_token_fault():
    """Plants the fault: prefill's logits shifted by one token, so the
    served token is the one after the argmax."""
    import repro_torch.launch.serve as SV

    orig = SV.prefill

    def shifted(cfg, params, batch, max_len):
        logits, state = orig(cfg, params, batch, max_len)
        return logits.roll(1, dims=-1), state

    SV.prefill = shifted
    return lambda: setattr(SV, "prefill", orig)


FAULTS = {"half_batch": half_batch_fault, "unchanged_state":
          unchanged_state_fault, "altered_token": altered_token_fault}
MODE_FAULT = {"train": "half_batch", "prefill": "altered_token"}


def reading(cell, seed, seconds, device, control=False):
    """One run of the cell's mode: its numbers, the control's where asked,
    and its end-to-end metrics."""
    import torch

    ctx = H.Context(cell, seed, seconds, False, device, time.perf_counter(),
                    torch, log=lambda *a: print(*a, file=sys.stderr,
                                                flush=True),
                    control=control)
    out = H.mode_module(cell.traffic).run(ctx)
    row = {"program": {name: v for name, v, _ in out.checks},
           "end_to_end": out.end_to_end}
    if out.control:
        row["control"] = out.control
    del out
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return row


def summary(rows) -> dict:
    """Each number's largest program reading, and its smallest control and
    fault readings."""
    out = {}
    for kind, pick in (("program", max), ("control", min), ("fault", min)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            out[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    cell = H.load_cell(ROOT, args.workload)
    fault = MODE_FAULT[cell.traffic["mode"]]
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control)):
        t0 = time.perf_counter()
        row = {"seed": seed, **reading(cell, seed, args.seconds, args.device,
                                       seed in args.control)}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    for seed in args.fault:
        undo = FAULTS[fault]()
        try:
            got = reading(cell, seed, args.seconds, args.device)
        finally:
            undo()
        row = {"seed": seed, "fault_kind": fault, "fault": got["program"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    result = {"workload": args.workload, "rows": rows,
              "summary": summary(rows)}
    if args.device == "cuda":
        result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result["summary"]))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
