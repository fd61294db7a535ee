"""Deterministic synthetic data pipeline implementing the paper's Fig. 1
*batching unit* and *batch assignment unit*.

The port's own copy of ``repro.data.pipeline``, numpy only, with the same
streams: every batch is bit-equal to the reference's for every (seed,
step, batch_id, n_batches).

The stream is a pure function of (seed, step, batch_id) — any worker can
regenerate any batch at any time, which is exactly what makes replicated
assignment and elastic re-batching cheap: re-planning B never moves data,
it only changes WHICH batch ids a data-axis coordinate pulls.

* ``global_batch(step)``            — the paper's dataset-for-this-job
* ``batch_for(step, batch_id, B)``  — the batching unit: B disjoint shards
* ``shard_for_coord(step, coord, plan)`` — the assignment unit: replica
  group members (same ``coord % B``) receive IDENTICAL data (Thm 1 balanced
  non-overlapping placement).

The audio and vlm families (frames, patch embeddings) are not ported:
:func:`make_batch_shapes` raises for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig, ShapeCell
from ..core.replication import ReplicationPlan, batch_index_for_data_coord

__all__ = ["TokenPipeline", "make_batch_shapes"]


def make_batch_shapes(cfg: ArchConfig, cell: ShapeCell) -> dict[str, tuple]:
    """Shapes of one GLOBAL batch for (arch, cell)."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family's batches are not ported")
        return {"tokens": (b, s), "labels": (b, s)}
    # decode: one new token per sequence
    return {"token": (b, 1)}


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    cell: ShapeCell
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )

    def _materialize(self, rng, shapes: dict[str, tuple]) -> dict[str, np.ndarray]:
        out = {}
        v = self.cfg.vocab_size
        for name, shape in shapes.items():
            if name in ("tokens", "token"):
                # markovian-ish synthetic stream: correlated tokens so the
                # model has something learnable (tests train-loss decrease)
                base = rng.integers(0, v, size=shape[:1] + (1,) * (len(shape) - 1))
                noise = rng.integers(0, 17, size=shape)
                out[name] = ((base + np.cumsum(noise, axis=-1)) % v).astype(np.int32)
        if "labels" in shapes:
            toks = out["tokens"]
            lab = np.roll(toks, -1, axis=-1)
            lab[..., -1] = 0
            out["labels"] = lab.astype(np.int32)
        return out

    # -- batching unit -----------------------------------------------------
    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        return self._materialize(
            self._rng(step), make_batch_shapes(self.cfg, self.cell)
        )

    def batch_for(self, step: int, batch_id: int, n_batches: int):
        """The paper's batch i of B: rows [i*gb/B, (i+1)*gb/B) of the global
        batch, regenerated locally (deterministic pure function of step)
        rather than shipped.  Because batches are literal SLICES of the same
        global batch, the RDP gradient mean over B batches equals the plain
        DP gradient over the global batch — replication changes placement,
        never semantics."""
        shapes = make_batch_shapes(self.cfg, self.cell)
        gb = next(iter(shapes.values()))[0]
        if gb % n_batches:
            raise ValueError(f"global batch {gb} not divisible by B={n_batches}")
        rows = gb // n_batches
        full = self.global_batch(step)
        return {
            k: v[batch_id * rows : (batch_id + 1) * rows] for k, v in full.items()
        }

    # -- assignment unit ---------------------------------------------------
    def shard_for_coord(
        self, step: int, data_coord: int, plan: ReplicationPlan
    ) -> dict[str, np.ndarray]:
        """What data-axis coordinate ``data_coord`` consumes this step: the
        batch of its replica group (identical across the group — Thm 1)."""
        bid = batch_index_for_data_coord(plan, data_coord)
        return self.batch_for(step, bid, plan.n_batches)
