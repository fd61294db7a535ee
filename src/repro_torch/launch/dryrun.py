"""Dry-run of every (arch x shape) cell: policy, placements, H100 roofline.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step for a TPU pod of 256 or 512 host-simulated
devices and reads XLA's memory and cost analyses.  The port keeps the
decisions and the counts and drops the XLA lowering; per cell it:

  1. takes the production mesh shape (16 x 16, 2 x 16 x 16, or the RDP
     factoring (replica, batch, model)) and the auto policy on it,
  2. builds the step's arguments as meta tensors and their placements
     (``launch.specs``),
  3. sums the bytes a device holds of parameters, optimizer state, the
     batch and the decode state: each tensor's bytes divided by the sizes
     of the axes it is placed on (the counterpart of XLA's
     ``memory_analysis``),
  4. counts the step on the meta device: the H100 roofline
     (``roofline.analysis``),
  5. reckons whether the step fits one 80 GB card (:func:`one_card`),
  6. writes ``<out>/<arch>__<shape>__<mesh>.json``.

A pair that ``cell_supported`` rejects is reported ``skipped`` with the
reference's reason.  The dry-run is the one entry point of the port that
does no work on a device: it counts shapes on the meta device, allocates
nothing on any card and needs none, as the reference's dry-run needs no
TPU.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every cell
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --all --rdp-batches 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

__all__ = ["run_cell", "placed_bytes", "train_memory", "one_card", "main"]

DEFAULT_OUT = "reports/torch_dryrun"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placed_bytes(tree, specs, mesh_shape) -> int:
    """Bytes one device holds of a tree of (meta) tensors under its
    placement tree: each tensor's bytes over the product of the sizes of
    the axes its dims are placed on."""
    if isinstance(tree, dict):
        return sum(placed_bytes(tree[k], specs[k], mesh_shape) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(placed_bytes(t, s, mesh_shape)
                   for t, s in zip(tree, specs))
    if len(specs) > tree.dim():
        raise ValueError(f"placement {specs} has more entries than the "
                         f"{tree.dim()} dims of {tuple(tree.shape)}")
    split = 1
    for entry in specs:
        for axis in _axes(entry):
            split *= mesh_shape[axis]
    return tree.numel() * tree.element_size() // split


def _leaf_elems(params):
    from ..tree import tree_leaves

    return [(t.numel(), t.element_size()) for t in tree_leaves(params)]


def train_memory(params, n_distinct: int, activation_bytes: float) -> dict:
    """The trainer's step on one card (``launch.train.Trainer``), phase by
    phase, in bytes, from the meta parameter tree:

    * ``backward``: the weights and the AdamW state (the parameters' own
      bytes and 12 a parameter of float32 m, v and master), the float32
      gradient trees of the n - 1 distinct batches done, and this batch's
      saved activations beside its gradients in the parameters' dtypes
      (an upper bound: the backward frees activations as it goes);
    * ``cast``: the activations gone, those gradients and their float32
      copy (a float32 leaf's gradient is its own copy);
    * ``aggregation``: the n float32 trees and their mean, built leaf by
      leaf (``aggregate_host``): the mean's leaves so far and two float32
      temporaries of the leaf being summed (one at n = 1);
    * ``update``: the mean and the in-place AdamW's four float32
      temporaries of its largest leaf at once (``optim.update_``).

    The peak is the largest phase.  ``n_distinct`` is the number of
    distinct batches whose gradients the step computes.  Beside it,
    ``reckoning_14_4_4`` is PERF.md's reckoning: 14 B a parameter, 4 B a
    distinct batch's gradient tree and 4 B their mean."""
    leaves = _leaf_elems(params)
    n_el = sum(e for e, _ in leaves)
    native = sum(e * b for e, b in leaves)
    state = native + 12 * n_el
    tree = 4 * n_el
    temps = 2 if n_distinct > 1 else 1
    agg = done = 0
    for e, _ in leaves:
        agg = max(agg, done + temps * 4 * e)
        done += 4 * e
    largest = max(e for e, _ in leaves)
    before = state + tree * (n_distinct - 1)
    phases = {
        "backward": before + activation_bytes + native,
        "cast": before + native + sum(4 * e for e, b in leaves if b != 4),
        "aggregation": state + tree * n_distinct + agg,
        "update": state + tree + 4 * 4 * largest,
    }
    peak = max(phases, key=phases.get)
    return {"phases": phases, "peak_phase": peak, "peak_bytes": phases[peak],
            "reckoning_14_4_4": 14 * n_el + tree * (n_distinct + 1),
            "parameters": n_el, "largest_leaf": largest}


def one_card(cfg, cell, counts: dict, n_distinct: int = 1) -> dict:
    """Whether the cell's step fits one card of ``roofline.CARD_BYTES``:
    train by :func:`train_memory` with the counted activations of the
    cell's global batch, prefill and decode the parameters and the decode
    state."""
    from ..roofline.analysis import CARD_BYTES, _meta_state, _tree_bytes
    from .specs import params_shapes

    params = params_shapes(cfg)
    if cell.kind == "train":
        mem = train_memory(params, n_distinct, counts["activation_bytes"])
        out = {"bytes": mem["peak_bytes"], "peak_phase": mem["peak_phase"],
               "phases": mem["phases"], "distinct_batches": n_distinct,
               "reckoning_14_4_4": mem["reckoning_14_4_4"]}
    else:
        state = _tree_bytes(_meta_state(cfg, cell.global_batch,
                                        cell.seq_len))
        out = {"bytes": counts["param_bytes"] + state,
               "phases": {"parameters": counts["param_bytes"],
                          "decode_state": state}}
    out["card_bytes"] = CARD_BYTES
    out["fits"] = out["bytes"] <= CARD_BYTES
    return out


def _mesh_name(multi_pod: bool, rdp_batches) -> str:
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return f"rdp{rdp_batches}x{name}" if rdp_batches else name


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: pathlib.Path,
             rdp_batches: int | None = None) -> dict:
    from ..configs import SHAPE_CELLS, cell_supported, get_config
    from ..roofline.analysis import analyze_cell, count_step
    from .mesh import mesh_size, production_mesh_shape
    from .mesh import rdp_production_mesh_shape
    from .policies import auto_policy
    from .specs import input_specs

    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    ok, reason = cell_supported(cfg, cell)
    tag = f"{arch}__{shape}__{_mesh_name(multi_pod, rdp_batches)}"
    if not ok:
        report = {"cell": tag, "status": "skipped", "reason": reason}
    else:
        t0 = time.perf_counter()
        if rdp_batches:
            # the paper's technique on the mesh: the data extent factored
            # into (replica, batch); parameters and batches follow batch
            mesh_shape, _ = rdp_production_mesh_shape(rdp_batches,
                                                      multi_pod=multi_pod)
            policy = dataclasses.replace(
                auto_policy(cfg, cell, mesh_shape), dp_axes=("batch",))
        else:
            mesh_shape = production_mesh_shape(multi_pod=multi_pod)
            policy = auto_policy(cfg, cell, mesh_shape)
        args, specs = input_specs(cfg, cell, policy, mesh_shape)
        names = {"train": ("params", "opt_state", "batch", "lr"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "decode_state", "token", "cache_len")}
        placed = {n: placed_bytes(a, s, mesh_shape)
                  for n, a, s in zip(names[cell.kind], args, specs)}
        t_specs = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts = count_step(cfg, cell.kind, cell.global_batch, cell.seq_len)
        t_count = time.perf_counter() - t0
        report = analyze_cell(cfg, cell, chips=mesh_size(mesh_shape),
                              counts=counts)
        report.update({
            "cell": tag, "status": "ok", "mesh": dict(mesh_shape),
            "policy": dataclasses.asdict(policy),
            "placed_bytes_per_device": placed,
            "one_card": one_card(cfg, cell, counts, rdp_batches or 1),
            "timings": {"specs_s": t_specs, "count_s": t_count},
        })
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(report, indent=2))
    return report


def _summary(r: dict) -> str:
    if r["status"] != "ok":
        return f"[{r['cell']}] skipped: {r['reason']}"
    oc = r["one_card"]
    return (f"[{r['cell']}] {r['dominant']} compute "
            f"{r['terms']['compute_s']:.4g} s memory "
            f"{r['terms']['memory_s']:.4g} s a device; useful "
            f"{r['useful_flop_ratio']:.3f}; params + state "
            f"{sum(r['placed_bytes_per_device'].values()) / 1e9:.3f} GB a "
            f"device; one card {oc['bytes'] / 1e9:.1f} GB "
            f"({'fits' if oc['fits'] else 'does not fit'})")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Policy, placements and the H100 roofline of every "
                    "(arch x shape) cell, counted on the meta device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rdp-batches", type=int, default=None,
                    help="factor the data extent into (replica, B) per the "
                         "paper")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS, SHAPE_CELLS

    out_dir = pathlib.Path(args.out)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPE_CELLS
                 if args.shape is None or s == args.shape]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                print(_summary(run_cell(arch, shape, mp, out_dir,
                                        rdp_batches=args.rdp_batches)),
                      flush=True)
            except Exception as e:  # noqa: BLE001 - report and go on
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall dry-run cells passed; reports in {out_dir}")


if __name__ == "__main__":
    main()
