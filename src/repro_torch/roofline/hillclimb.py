"""Perf-hillclimb reporting: apply the kernel-substitution model to the
dry-run reports of the selected cells and write
``reports/torch_perf_hillclimb.json``.

The counterpart of ``repro.roofline.hillclimb``.  For each cell it
writes three sets of terms: ``as_plain``, the step walked with the
kernels' plain twins in their place (the reference's ``as_compiled``,
XLA's unfused attention); ``kernel_substituted``, that walk with the
attention traffic replaced by the kernel's modeled bytes
(``kernel_model``), with the bound that set it (``"substitution"``,
``"floor"`` or ``"cap"``: the model subtracts XLA's attention traffic,
which can exceed what the plain walk holds, and a clamp then sets the
bytes); and ``as_run``, the step walked as the port runs it, each
kernel wrapper's noted bytes in place of its twin's ops.  The last
holds the model's substitution against a count of what the port runs.
A cell whose report is missing is skipped.

Run: PYTHONPATH=src python -m repro_torch.roofline.hillclimb
     [--reports reports/torch_dryrun] [--out reports/torch_perf_hillclimb.json]
(after ``python -m repro_torch.launch.dryrun --all --both-meshes``).
"""

from __future__ import annotations

import argparse
import json
import pathlib

__all__ = ["CELLS", "run", "main"]

REPORTS = pathlib.Path("reports/torch_dryrun")
OUT = pathlib.Path("reports/torch_perf_hillclimb.json")

CELLS = [
    ("qwen2-0.5b", "train_4k", "pod16x16"),
    ("qwen2-0.5b", "prefill_32k", "pod16x16"),
    ("qwen2.5-14b", "train_4k", "pod16x16"),
    ("command-r-plus-104b", "train_4k", "pod16x16"),
    ("internvl2-76b", "train_4k", "pod16x16"),
    ("qwen2.5-14b", "train_4k", "pod2x16x16"),
    ("xlstm-350m", "train_4k", "pod16x16"),
]


def _policy_from_report(rep: dict):
    from ..configs.base import ShardingPolicy

    p = dict(rep["policy"])
    p["dp_axes"] = tuple(p.get("dp_axes", ("data",)))
    return ShardingPolicy(**p)


def _terms(rep: dict, nbytes: float) -> dict:
    from .analysis import HBM_BW

    terms = dict(rep["terms"], memory_s=nbytes / HBM_BW)
    return {"terms": terms, "dominant": max(terms, key=terms.get)}


def run(reports=REPORTS, out=OUT) -> dict:
    from ..configs import SHAPE_CELLS, get_config
    from .kernel_model import kernel_adjusted_terms

    reports, out_path = pathlib.Path(reports), pathlib.Path(out)
    result = {}
    for arch, shape, mesh_tag in CELLS:
        path = reports / f"{arch}__{shape}__{mesh_tag}.json"
        if not path.exists():
            continue
        rep = json.loads(path.read_text())
        if rep.get("status") != "ok":
            continue
        cfg = get_config(arch)
        cell = SHAPE_CELLS[shape]
        plain_bytes = rep["bytes_per_device_plain"]
        plain = dict(_terms(rep, plain_bytes), bytes_per_device=plain_bytes)
        adj = kernel_adjusted_terms(plain, cfg, cell,
                                    _policy_from_report(rep), rep["mesh"])
        result[f"{arch}__{shape}__{mesh_tag}"] = {
            "as_plain": {
                "terms": plain["terms"],
                "dominant": plain["dominant"],
                "useful": rep["useful_flop_ratio"],
                "bytes_per_device": plain_bytes,
            },
            "kernel_substituted": {
                "terms": adj["terms"],
                "dominant": adj["dominant"],
                "bytes_per_device": adj["bytes_per_device"],
                "bound": adj["bound"],
                "attention_plain_bytes": adj["attention_traffic"][
                    "plain_bytes"],
                "attention_kernel_bytes": adj["attention_traffic"][
                    "kernel_bytes"],
            },
            "as_run": {
                "terms": rep["terms"],
                "dominant": rep["dominant"],
                "bytes_per_device": rep["bytes_per_device"],
            },
        }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    for k, v in result.items():
        print(k)
        for name in ("as_plain", "kernel_substituted", "as_run"):
            t = {kk: round(vv, 4) for kk, vv in v[name]["terms"].items()}
            bound = v[name].get("bound")
            print(f"  {name:<18} {t} dom={v[name]['dominant']}"
                  + (f" bound={bound}" if bound else ""))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline.hillclimb",
        description="The kernel-substituted roofline of the dry-run's "
                    "cells, beside the plain and the as-run walks.")
    ap.add_argument("--reports", default=str(REPORTS))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    run(args.reports, args.out)


if __name__ == "__main__":
    main()
