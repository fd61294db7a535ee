"""Checkpointing with async writes and elastic restore, in the layout of
``repro.checkpoint``:

    step_000123/
      manifest.json      # tree structure, leaf dtypes, metadata (plan, step)
      leaves.npz         # flat leaf arrays (leaf_00000, leaf_00001, ...)

Leaves are numbered in JAX's flattening order (dict keys sorted, lists in
order: :func:`repro_torch.tree.tree_leaves`).  bfloat16 leaves are stored
as their raw ``uint16`` bits with ``"bfloat16"`` in the manifest's dtypes,
as the reference stores them; the bits go through torch views
(``torch.bfloat16`` <-> ``int16``), so nothing here needs ``ml_dtypes``.
A checkpoint of the same tree written by either package restores in the
other.

Writes go to ``<name>.tmp`` then atomically rename, so a crash mid-write
never corrupts the latest checkpoint.  ``save_async`` copies every leaf to
the host before its thread starts, then serializes in the background; the
training loop only blocks on the previous write (one in flight).
``restore`` returns the example's structure with each leaf a tensor cast
to the example leaf's dtype and device.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_leaves, tree_structure, tree_unflatten

__all__ = ["Checkpointer", "latest_step"]


def latest_step(root: str | pathlib.Path) -> Optional[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.is_dir() and p.name.startswith("step_") and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, true dtype name) of one leaf: a host copy, so the
    caller may go on to overwrite its tensors."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: Optional[str], example):
    """The stored array as a tensor of the example leaf's dtype and device
    (a leaf that is not a tensor gets the stored dtype, on the host)."""
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(example, torch.Tensor):
        return t.to(device=example.device, dtype=example.dtype)
    return t


@dataclasses.dataclass
class Checkpointer:
    root: str
    keep: int = 3

    def __post_init__(self):
        self._root = pathlib.Path(self.root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write --------------------------------------------------------------
    def save(self, step: int, state: Any, metadata: dict | None = None) -> None:
        host = [_to_host(l) for l in tree_leaves(state)]
        self._write(step, host, tree_structure(state), metadata or {})

    def save_async(self, step: int, state: Any, metadata: dict | None = None) -> None:
        self.wait()  # bound to one in-flight write
        host = [_to_host(l) for l in tree_leaves(state)]  # device->host now
        structure = tree_structure(state)

        def work():
            try:
                self._write(step, host, structure, metadata or {})
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _write(self, step, host, structure, metadata):
        final = self._root / f"step_{step:08d}"
        tmp = self._root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {f"leaf_{i:05d}": arr for i, (arr, _) in enumerate(host)}
        np.savez(tmp / "leaves.npz", **arrays)
        manifest = {
            "step": step,
            "treedef": structure,
            "n_leaves": len(host),
            "dtypes": [dt for _, dt in host],
            "metadata": metadata,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = sorted(
            p
            for p in self._root.iterdir()
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )
        for p in steps[: -self.keep]:
            shutil.rmtree(p)

    # -- read ---------------------------------------------------------------
    def restore(self, example_state: Any, step: Optional[int] = None):
        """Returns (state, metadata).  ``example_state`` supplies the tree
        structure and each leaf's target dtype and device; the leaf count
        must match."""
        if step is None:
            step = latest_step(self._root)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self._root}")
        d = self._root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        ex_leaves = tree_leaves(example_state)
        if len(ex_leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected "
                f"{len(ex_leaves)}"
            )
        dtypes = manifest.get("dtypes", [None] * len(ex_leaves))
        with np.load(d / "leaves.npz") as data:
            leaves = [_from_host(data[f"leaf_{i:05d}"], dtypes[i], ex)
                      for i, ex in enumerate(ex_leaves)]
        return tree_unflatten(example_state, leaves), manifest["metadata"]
