"""Worker-side batch payloads: what a DISPATCH actually executes.

A payload spec is a plain JSON-able dict (it rides the DISPATCH message);
:func:`run_payload` executes it on the worker and returns the measured
wall-clock elapsed time.  Three kinds:

* ``sleep``         — service time drawn worker-side from a calibrated
  straggler distribution (Exp / shifted-Exp / deterministic), seeded per
  (job, attempt, replica) so replicas are iid draws and whole runs are
  reproducible.  This is the calibration payload: the coordinator never
  learns the draw, only the measured completion — exactly the telemetry a
  real fleet produces.
* ``deterministic`` — fixed duration; the CI payload (timing-assertable).
* ``matmul``        — real compute: repeated torch matmul + trace reduction
  on an (n x n) shard on the worker's device, for runs where the "service
  distribution" must come from actual hardware contention rather than a
  model.  The shard is ``torch.randn((n, n))`` drawn on that device from
  ``torch.Generator(device).manual_seed(seed % 2**31)``; each repeat is
  ``x = tanh(x @ x.T / n)`` and the checksum sums ``trace(x)``.  The
  device is resolved only when a matmul payload runs (``device=None`` means
  ``"cuda"`` and raises ``RuntimeError`` without a card; ``"cpu"`` runs on
  the host), so sleep/deterministic workers never touch CUDA.
* ``coded``         — the coded-computation data plane: the worker
  regenerates the job's data blocks from ``data_seed`` (data never rides
  the wire — only the spec does), applies its per-worker coefficient
  ``row`` (one row of the scheme's encode matrix, shipped in DISPATCH),
  and returns the coded partial combination as its RESULT value.  The
  coordinator decodes once ANY k of the N partials arrive
  (:meth:`repro_torch.core.coding.MDSCode.decode_weights` /
  :meth:`repro_torch.core.gradient_coding.CyclicGradientCode.decode_weights`)
  and cancels the stragglers — a k-of-n quorum instead of
  first-replica-wins.  An optional embedded sleep model supplies the
  straggler service time on top of the (tiny) real combination.

Cancellation: payloads poll a :class:`threading.Event` (sleeps wait ON it),
so a CANCEL interrupts within one slice.  A chaos slowdown factor
multiplies the duration (sleep kinds) or the repeat count (matmul) —
straggling is injected INSIDE the worker, where the coordinator cannot see
it except through telemetry.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

__all__ = ["make_sleep_spec", "make_deterministic_spec", "make_matmul_spec",
           "make_coded_spec", "coded_data_blocks", "payload_duration",
           "run_payload"]

_SLICE = 0.02  # max uninterruptible wait (s): bounds cancel latency


def make_sleep_spec(
    family: str, work: float = 1.0, *, delta: float = 0.0, mu: float = 1.0
) -> dict:
    """Sleep-from-distribution spec: service for ``work`` units of data.

    ``family`` is ``'exp'`` or ``'sexp'`` (shifted exponential, the paper's
    model); the draw follows the affine load model used everywhere else in
    the repo — ``dist.scaled(work)`` — i.e. ``work * (delta + Exp(mu))``.
    """
    if family not in ("exp", "sexp"):
        raise ValueError(f"unknown sleep family {family!r} (use 'exp'|'sexp')")
    if mu <= 0 or work <= 0 or delta < 0:
        raise ValueError(
            f"need mu > 0, work > 0, delta >= 0; got {mu}, {work}, {delta}"
        )
    return {
        "kind": "sleep",
        "family": family,
        "delta": float(delta),
        "mu": float(mu),
        "work": float(work),
    }


def make_deterministic_spec(duration: float) -> dict:
    """Fixed-duration spec (CI: completion times are assertable)."""
    if duration < 0:
        raise ValueError(f"duration must be >= 0, got {duration}")
    return {"kind": "deterministic", "duration": float(duration)}


def make_matmul_spec(size: int = 256, repeats: int = 4) -> dict:
    """Real-compute spec: ``repeats`` (size x size) matmuls + trace."""
    if size < 1 or repeats < 1:
        raise ValueError(f"need size, repeats >= 1; got {size}, {repeats}")
    return {"kind": "matmul", "size": int(size), "repeats": int(repeats)}


def coded_data_blocks(
    data_seed: int, n_blocks: int, block_dim: int
) -> np.ndarray:
    """(n_blocks, block_dim) data blocks regenerated from ``data_seed``.

    Coordinator and every worker call this with identical arguments, so the
    coded data plane ships only a seed — the blocks themselves never cross
    the wire, and the coordinator can verify a decoded result against the
    ground truth it computes locally.
    """
    if n_blocks < 1 or block_dim < 1:
        raise ValueError(
            f"need n_blocks, block_dim >= 1; got {n_blocks}, {block_dim}"
        )
    rng = np.random.default_rng(int(data_seed))
    return rng.standard_normal((int(n_blocks), int(block_dim)))


def make_coded_spec(
    row,
    *,
    data_seed: int = 0,
    block_dim: int = 16,
    family: Optional[str] = None,
    delta: float = 0.0,
    mu: float = 1.0,
    work: float = 1.0,
) -> dict:
    """Coded-partial spec: one worker's share of a k-of-n coded job.

    ``row`` is this worker's row of the scheme's encode matrix (length =
    the number of data blocks); the worker computes ``row @ blocks`` where
    the blocks come from :func:`coded_data_blocks`.  ``family`` (plus
    ``delta``/``mu``/``work``) optionally embeds the same straggler sleep
    model as ``make_sleep_spec`` — ``work`` here is the PER-WORKER coded
    load (the coordinator scales it by ``CodingCandidate.load(N) / N``), so
    the timing matches the planner's size-dependent service model.
    """
    row = [float(v) for v in np.asarray(row, dtype=float).ravel()]
    if not row:
        raise ValueError("coefficient row must be non-empty")
    if family is not None and family not in ("exp", "sexp"):
        raise ValueError(f"unknown sleep family {family!r} (use 'exp'|'sexp')")
    if family is not None and (mu <= 0 or work <= 0 or delta < 0):
        raise ValueError(
            f"need mu > 0, work > 0, delta >= 0; got {mu}, {work}, {delta}"
        )
    return {
        "kind": "coded",
        "row": row,
        "data_seed": int(data_seed),
        "block_dim": int(block_dim),
        "family": family,
        "delta": float(delta),
        "mu": float(mu),
        "work": float(work),
    }


def payload_duration(spec: dict, seed: int) -> Optional[float]:
    """The duration a timed spec will run for under ``seed`` (None for
    matmul, whose duration is genuinely unknown until executed)."""
    kind = spec["kind"]
    if kind == "deterministic":
        return float(spec["duration"])
    if kind == "sleep":
        rng = np.random.default_rng(seed)
        base = rng.exponential(1.0 / float(spec["mu"]))
        if spec["family"] == "sexp":
            base += float(spec["delta"])
        return base * float(spec["work"])
    if kind == "coded":
        if spec.get("family") is None:
            return 0.0  # pure combination: effectively instantaneous
        rng = np.random.default_rng(seed)
        base = rng.exponential(1.0 / float(spec["mu"]))
        if spec["family"] == "sexp":
            base += float(spec["delta"])
        return base * float(spec["work"])
    if kind == "matmul":
        return None
    raise ValueError(f"unknown payload kind {kind!r}")


def _interruptible_sleep(duration: float, cancel: threading.Event) -> bool:
    """Sleep ``duration`` seconds; True if cancelled before it elapsed."""
    deadline = time.monotonic() + duration
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        if cancel.wait(min(remaining, _SLICE)):
            return True


def _run_matmul(spec: dict, seed: int, repeats: int,
                cancel: threading.Event, device=None) -> tuple:
    """(checksum or None if cancelled, the device it ran on)."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n = int(spec["size"])
    gen = torch.Generator(device=dev).manual_seed(seed % (2**31))
    x = torch.randn((n, n), generator=gen, device=dev)
    acc = 0.0
    for _ in range(repeats):
        if cancel.is_set():
            return None, str(x.device)
        x = torch.tanh(x @ x.T / n)
        acc += float(torch.trace(x))
    return acc, str(x.device)


def run_payload(
    spec: dict,
    *,
    seed: int,
    cancel: threading.Event,
    slowdown: float = 1.0,
    device=None,
) -> dict:
    """Execute one payload; returns the RESULT fields the worker reports.

    ``{"elapsed": wall-seconds, "cancelled": bool, "value": float|None}`` —
    ``elapsed`` is measured even when cancelled (it is the coordinator's
    censoring bound), ``value`` is a checksum proving real work happened
    (matmul) or the drawn duration (sleep kinds).  A matmul result also
    carries ``"device"``, the torch device it ran on (``device``, resolved
    by the device rule).
    """
    if slowdown <= 0:
        raise ValueError(f"slowdown must be positive, got {slowdown}")
    start = time.monotonic()
    kind = spec["kind"]
    if kind in ("sleep", "deterministic"):
        duration = payload_duration(spec, seed) * slowdown
        was_cancelled = _interruptible_sleep(duration, cancel)
        value = None if was_cancelled else duration
    elif kind == "coded":
        duration = payload_duration(spec, seed) * slowdown
        was_cancelled = duration > 0 and _interruptible_sleep(duration, cancel)
        if was_cancelled or cancel.is_set():
            was_cancelled, value = True, None
        else:
            row = np.asarray(spec["row"], dtype=float)
            blocks = coded_data_blocks(
                spec["data_seed"], row.size, spec["block_dim"]
            )
            value = [float(v) for v in row @ blocks]
    elif kind == "matmul":
        repeats = max(1, round(int(spec["repeats"]) * slowdown))
        value, ran_on = _run_matmul(spec, seed, repeats, cancel, device)
        return {
            "elapsed": time.monotonic() - start,
            "cancelled": value is None,
            "value": value,
            "device": ran_on,
        }
    else:
        raise ValueError(f"unknown payload kind {kind!r}")
    return {
        "elapsed": time.monotonic() - start,
        "cancelled": bool(was_cancelled),
        "value": value,
    }
