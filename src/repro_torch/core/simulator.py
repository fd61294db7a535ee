"""Monte-Carlo sweeps of the paper's System1 on a torch device.

The port of the planning half of ``repro.core.simulator``: every entry
point scores ALL candidate cells — (distribution, B), (distribution, B,
straggler policy) or (distribution, coding candidate) — from ONE shared
matrix of unit-exponential draws (common random numbers), on ``device``
(default ``"cuda"``; ``"cpu"`` runs the kernels' plain twins).

* :func:`sweep_simulate` — batch completion ``max_b min_{j in b} T_j`` of
  every split, the torch twin of the reference's ``_sweep_jax``.
* :func:`sweep_sojourn`, :func:`sweep_sojourn_speculative`,
  :func:`sweep_sojourn_policies` — sojourn times under an arrival process,
  through the ``sojourn_cells`` kernel.
* :func:`sweep_coded`, :func:`sweep_sojourn_coded` — coded k-of-N cells
  through the ``coded_cells`` kernel (and ``sojourn_cells`` at G=1).
* :func:`sweep_sojourn_serving`, :func:`simulate_sojourn_serving` — the
  multi-tenant serving sweep: per-request latencies of every (B, policy,
  max_wait, shed) cell under SLO classes, the job streams of a host-side
  WFQ formation pre-pass scanned by ``sojourn_cells``.
* :func:`simulate_maxmin`, :func:`simulate_coverage` — batch completion of
  ONE placement (balanced, or any :class:`Assignment` under the coverage
  rule) in float64 torch ops; :func:`simulate_coverage_reference` is the
  per-trial host walk they are held to.
* :func:`simulate_sojourn`, :func:`simulate_sojourn_quantiles`,
  :func:`simulate_sojourn_policies` — sojourns of ONE (B, placement), one
  ``sojourn_cells`` launch each, the rate-aware planner's per-B path.
* :class:`StepTimeSimulator`, :func:`completion_from_step_times`,
  :func:`censored_observations` — per-step, per-worker telemetry on the
  host (numpy), the tuner's input.

Randomness and precision follow the reference exactly: the draws are
``np.random.default_rng(seed)`` in the reference's order (arrivals, then
the primary matrix, then the alternate matrix), moved to the device once
as float64; every transform stays in float64 up to the point where the
reference's device lane casts to float32, and the kernels compute in
float32.  So each cell is bit-equal to the reference's ``pallas`` lane.
Divisions by a constant go through a device tensor (:func:`_div`): a CUDA
division by a host scalar may be done as a multiplication by its
reciprocal, which is not the same float.

:data:`STAGE_SECONDS` adds up the host seconds each sweep spends in its
stages (numpy draws, host-to-device copy, group minima, trigger thresholds,
cell build, scan; for the serving sweep also the formation pre-pass, and
the planner's request-level scoring); a caller zeroes it with
:func:`reset_stage_seconds`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels import sojourn_sweep as _ss
from .coding import CodingCandidate
from .order_stats import Empirical, ServiceDistribution
from .policies import (
    Assignment,
    PolicyCandidate,
    ShedPolicy,
    SloClass,
    _validate_rates,
    divisors,
)

__all__ = [
    "SimResult",
    "SweepSimResult",
    "SpeculativeSweepResult",
    "PolicySweepResult",
    "CodedSweepResult",
    "ServingSweepResult",
    "ServingSimResult",
    "sweep_simulate",
    "sweep_coded",
    "sweep_sojourn",
    "sweep_sojourn_speculative",
    "sweep_sojourn_policies",
    "sweep_sojourn_coded",
    "sweep_sojourn_serving",
    "simulate_sojourn_serving",
    "simulate_maxmin",
    "simulate_coverage",
    "simulate_coverage_reference",
    "simulate_sojourn",
    "simulate_sojourn_quantiles",
    "simulate_sojourn_policies",
    "StepTimeSimulator",
    "FaultEvent",
    "censored_observations",
    "completion_from_step_times",
    "STAGE_SECONDS",
    "reset_stage_seconds",
]

F32 = torch.float32
F64 = torch.float64

# Host seconds per sweep stage, summed over calls.  Each is the host clock
# between the stage's boundaries with no synchronisation added, so device
# work a stage queues is charged to the stage that next waits for it (the
# group minima to the thresholds' copy to the host, the scan to its own
# copy of the samples).
STAGE_SECONDS: dict[str, float] = {}


def reset_stage_seconds() -> None:
    STAGE_SECONDS.clear()


@contextlib.contextmanager
def _stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STAGE_SECONDS[name] = (STAGE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


@dataclasses.dataclass(frozen=True)
class SimResult:
    samples: np.ndarray  # (n_trials,) completion times

    @property
    def mean(self) -> float:
        return float(self.samples.mean())

    @property
    def var(self) -> float:
        return float(self.samples.var(ddof=1))

    @property
    def std(self) -> float:
        return float(self.samples.std(ddof=1))

    def quantile(self, q: float) -> float:
        return float(np.quantile(self.samples, q))

    @property
    def stderr(self) -> float:
        return float(self.samples.std(ddof=1) / np.sqrt(len(self.samples)))


# ---------------------------------------------------------------------------
# shared sampling core (device tensors)
# ---------------------------------------------------------------------------


def _div(x: torch.Tensor, y) -> torch.Tensor:
    """``x / y`` as a true division on every device (``y`` a host number
    or array is moved to ``x``'s device first)."""
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(np.asarray(y, dtype=np.float64), device=x.device)
    return x / y.to(x.dtype)


def _dist_params(dist: ServiceDistribution) -> tuple[float, float]:
    """(shift, mu) of the unit-load service distribution (Exp/SExp-shaped:
    anything exposing ``mu`` and optionally ``delta``)."""
    mu = getattr(dist, "mu", None)
    if mu is None:
        raise TypeError(
            f"{type(dist).__name__} must expose 'mu' (and optional 'delta') "
            "for the vectorized engine (or be an Empirical distribution)"
        )
    return float(getattr(dist, "delta", 0.0)), float(mu)


def _atoms(dist: Empirical, device) -> torch.Tensor:
    return torch.as_tensor(dist._atoms_arr, device=device)


def _ppf(dist: Empirical, u: torch.Tensor) -> torch.Tensor:
    """Inverse ECDF on a device: smallest atom with cumulative weight >= u
    (``np.searchsorted(..., side='left')``, clipped to the last atom)."""
    cw = torch.as_tensor(dist._cum_weights, device=u.device)
    idx = torch.searchsorted(cw, u.contiguous(), right=False)
    return _atoms(dist, u.device)[idx.clamp(max=dist.n_atoms - 1)]


def _empirical_coupled_times(dist: Empirical, unit: torch.Tensor,
                             order: torch.Tensor | None = None) -> torch.Tensor:
    """Quantile-coupled empirical times from the SHARED Exp(1) draws.

    Draw ``k``-th-smallest maps to the ``k``-th stratified ECDF quantile at
    level ``(2k+1)/(2M)``; uniform weights index with pure integers, so a
    pool that is an exact monotone transform of the draws reproduces it bit
    for bit (the reference's parity contract).
    """
    flat = unit.reshape(-1)
    m = flat.numel()
    dev = unit.device
    if order is None:
        order = torch.sort(flat, stable=True).indices
    n = dist.n_atoms
    k = torch.arange(m, device=dev, dtype=torch.int64)
    if dist.weights is None:
        vals = _atoms(dist, dev)[(2 * k + 1) * n // (2 * m)]
    else:
        levels = _div(2.0 * k.to(F64) + 1.0, 2.0 * m)
        vals = _ppf(dist, levels)
    out = torch.empty(m, dtype=F64, device=dev)
    out[order] = vals
    return out.reshape(unit.shape)


def _unit_times(unit: torch.Tensor, dist: ServiceDistribution,
                rates: np.ndarray | None,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """Unit-load float64 service times from the shared Exp(1) draws.

    Parametric: ``shift + E/(mu*rate)``.  Empirical: rank-coupled inverse
    ECDF, and a rate multiplier scales the WHOLE draw (``t / rate``).
    """
    if isinstance(dist, Empirical):
        core = _empirical_coupled_times(dist, unit, order=order)
        return core if rates is None else _div(core, rates)
    shift, mu = _dist_params(dist)
    denom = mu if rates is None else mu * rates
    return shift + _div(unit, denom)


def _shared_draw_order(dists: Sequence[ServiceDistribution],
                       unit: torch.Tensor) -> torch.Tensor | None:
    """The coupling argsort of one shared draw matrix, hoisted across dists
    (the rank pattern of the draws is distribution-independent)."""
    if any(isinstance(d, Empirical) for d in dists):
        return torch.sort(unit.reshape(-1), stable=True).indices
    return None


def _draws(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """One Exp(1) draw matrix from the reference's numpy stream, moved to
    the device once as float64."""
    with _stage("draws"):
        host = rng.standard_exponential(shape)
    with _stage("h2d"):
        return torch.as_tensor(host, device=device)


def _draw_worker_times(dist: ServiceDistribution, loads: np.ndarray,
                       n_trials: int, seed: int, rates: np.ndarray | None,
                       device) -> torch.Tensor:
    """(n_trials, N) float64 worker times ``unit_time_j * loads_j`` on the
    device: the per-placement entry points' one draw matrix."""
    rng = np.random.default_rng(seed)
    unit = _draws(rng, (n_trials, len(loads)), device)
    return _unit_times(unit, dist, rates) * torch.as_tensor(
        np.asarray(loads, dtype=np.float64), device=device)


# ---------------------------------------------------------------------------
# validation (shared with the reference's contracts)
# ---------------------------------------------------------------------------


def _normalize_dists(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
) -> tuple[ServiceDistribution, ...]:
    if isinstance(dists, ServiceDistribution):
        return (dists,)
    out = tuple(dists)
    if not out:
        raise ValueError("at least one distribution required")
    return out


def _validate_worker_batches(
    worker_batches, splits: Sequence[int], n_workers: int
) -> tuple[np.ndarray, ...] | None:
    """Per-split worker->set maps (rate-aware placements), validated."""
    if worker_batches is None:
        return None
    wbs = tuple(np.asarray(wb, dtype=int) for wb in worker_batches)
    if len(wbs) != len(splits):
        raise ValueError(
            f"worker_batches has {len(wbs)} entries for {len(splits)} splits"
        )
    for wb, b in zip(wbs, splits):
        if wb.shape != (n_workers,):
            raise ValueError(f"worker_batch shape {wb.shape} != ({n_workers},)")
        if wb.min() < 0 or wb.max() >= b:
            raise ValueError(f"worker_batch ids out of range for B={b}")
    return wbs


def _resolve_splits(n_workers, feasible_b, worker_batches=None):
    """The swept splits (divisors of N by default) and their validated
    per-split worker->set maps (None for the contiguous grouping, where
    every B must divide N)."""
    splits = list(feasible_b) if feasible_b is not None else divisors(n_workers)
    if not splits:
        raise ValueError("no feasible B values")
    wbs = _validate_worker_batches(worker_batches, splits, n_workers)
    if wbs is None:
        for b in splits:
            if n_workers % b:
                raise ValueError(f"B={b} infeasible: must divide N={n_workers}")
    return splits, wbs


def _validate_load(arrival_rate: float, job_load: float) -> None:
    if arrival_rate <= 0 or not np.isfinite(arrival_rate):
        raise ValueError(f"arrival_rate must be positive, got {arrival_rate}")
    if job_load <= 0:
        raise ValueError(f"job_load must be positive, got {job_load}")


def _resolve_warmup(n_jobs: int, warmup: int | None) -> int:
    w = n_jobs // 10 if warmup is None else int(warmup)
    if not 0 <= w < n_jobs:
        raise ValueError(f"warmup={w} out of range for n_jobs={n_jobs}")
    return w


def _validate_policies(
    policies: Sequence[PolicyCandidate],
) -> tuple[PolicyCandidate, ...]:
    seq = tuple(policies)
    if not seq:
        raise ValueError("at least one policy candidate required")
    for p in seq:
        if not isinstance(p, PolicyCandidate):
            raise TypeError(
                f"policies must be PolicyCandidate instances, got {type(p).__name__}"
            )
    return seq


def _validate_quantiles(quantiles) -> None:
    for q in quantiles:
        if q is not None and not 0.0 < q < 1.0:
            raise ValueError(f"speculation quantile must be in (0, 1), got {q}")


def _trigger_policy(q: float | None) -> PolicyCandidate:
    """The policy cell of a speculation quantile (None: no speculation)."""
    return PolicyCandidate("none") if q is None else PolicyCandidate("clone", q)


def _validate_coding_candidates(
    candidates: Sequence[CodingCandidate], n_workers: int
) -> tuple[CodingCandidate, ...]:
    cands = tuple(candidates)
    if not cands:
        raise ValueError("at least one coding candidate required")
    for c in cands:
        if not isinstance(c, CodingCandidate):
            raise TypeError(
                f"coding candidates must be CodingCandidate, got "
                f"{type(c).__name__}"
            )
        c.k(n_workers)  # raises when s >= N
    return cands


def _resolve_arrivals(
    arrivals: Sequence[float] | None,
    n_jobs: int,
    arrival_rate: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """The sweep's arrival sequence: the caller's offsets, else Poisson.

    Poisson arrivals consume n_jobs exponentials BEFORE the service draws
    (the reference's order).  A provided sequence must be 1-D, finite and
    non-decreasing; a shorter one is CYCLED, each lap offset by the trace
    span plus one mean gap, and consumes no randomness.
    """
    if arrivals is None:
        return np.cumsum(rng.standard_exponential(n_jobs)) / arrival_rate
    arr = np.asarray(arrivals, dtype=float)
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError("arrivals must be a non-empty 1-D sequence")
    if np.any(~np.isfinite(arr)) or np.any(np.diff(arr) < 0):
        raise ValueError("arrivals must be finite and non-decreasing")
    if arr.size < n_jobs:
        span = float(arr[-1] - arr[0])
        lap = span + span / (arr.size - 1) if span > 0 else 1.0
        reps = -(-n_jobs // arr.size)  # ceil
        arr = np.concatenate([arr + k * lap for k in range(reps)])
    return arr[:n_jobs]


def _group_min_times(core: torch.Tensor, worker_batch: np.ndarray,
                     n_groups: int) -> torch.Tensor:
    """(n_jobs, n_groups) per-set service times: min over member workers."""
    svc = torch.empty((core.shape[0], n_groups), dtype=core.dtype,
                      device=core.device)
    for g in range(n_groups):
        members = np.flatnonzero(worker_batch == g)
        if members.size == 0:
            raise ValueError(f"replica-set {g} has no workers")
        idx = torch.as_tensor(members, device=core.device)
        svc[:, g] = core[:, idx].amin(dim=1)
    return svc


def _wb_cache_tag(worker_batches) -> object:
    if worker_batches is None:
        return None
    return tuple(wb.tobytes() for wb in worker_batches)


# ---------------------------------------------------------------------------
# batch completion: every (B, r) split x distribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepSimResult:
    """Samples for every (distribution, split) pair of one batched sweep.

    ``samples[d, s]`` holds the completion (or post-warmup sojourn) times
    for ``dists[d]`` at ``splits[s]`` batches, all from one shared draw
    matrix.  ``backend`` records the device that ran: ``"cuda"`` or
    ``"cpu"``.
    """

    n_workers: int
    splits: tuple[int, ...]
    dists: tuple[ServiceDistribution, ...]
    samples: np.ndarray  # (n_dists, n_splits, n_trials)
    backend: str

    def result(self, n_batches: int, dist_index: int = 0) -> SimResult:
        return SimResult(self.samples[dist_index, self.splits.index(n_batches)])

    def means(self) -> np.ndarray:
        """(n_dists, n_splits) empirical mean completion times."""
        return self.samples.mean(axis=2)

    def variances(self) -> np.ndarray:
        return self.samples.var(axis=2, ddof=1)

    def best_mean(self, dist_index: int = 0) -> tuple[int, float]:
        """(argmin-B, mean) for one distribution."""
        m = self.means()[dist_index]
        k = int(np.argmin(m))
        return self.splits[k], float(m[k])

    def table(self, dist_index: int = 0) -> dict[int, SimResult]:
        return {
            b: SimResult(self.samples[dist_index, i])
            for i, b in enumerate(self.splits)
        }


def sweep_simulate(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    n_trials: int = 20_000,
    seed: int = 0,
    feasible_b: Sequence[int] | None = None,
    rates: Sequence[float] | None = None,
    device=None,
    worker_batches: Sequence[Sequence[int]] | None = None,
) -> SweepSimResult:
    """Simulate ALL feasible (B, r) splits x distributions in one call.

    The float32 device lane of the reference: the float64 unit-load cores
    are cast to float32, scaled by the split's load ``N/B`` (float32), the
    min over each replica set is taken (a segment-min over the worker->set
    map; sets past ``B`` do not exist), and the max over sets is the
    completion.  Min and max are exact, so the samples equal the
    reference's ``jax``/``pallas`` lanes bit for bit.
    """
    dist_seq = _normalize_dists(dists)
    splits, wbs = _resolve_splits(n_workers, feasible_b, worker_batches)
    rates_arr = _validate_rates(rates, n_workers)
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    unit = _draws(rng, (n_trials, n_workers), dev)
    order = _shared_draw_order(dist_seq, unit)
    samples = torch.empty((len(dist_seq), len(splits), n_trials), dtype=F64,
                          device=dev)
    for di, dist in enumerate(dist_seq):
        core = _unit_times(unit, dist, rates_arr, order=order).to(F32)
        for si, b in enumerate(splits):
            times = core * torch.tensor(n_workers / b, dtype=F32, device=dev)
            if wbs is None:
                bmin = times.reshape(n_trials, b, n_workers // b).amin(dim=2)
            else:
                idx = torch.as_tensor(wbs[si], device=dev).expand(n_trials, -1)
                bmin = torch.full((n_trials, b), float("inf"), dtype=F32,
                                  device=dev).scatter_reduce(
                    1, idx, times, reduce="amin", include_self=True)
            samples[di, si] = bmin.amax(dim=1).to(F64)
    return SweepSimResult(
        n_workers=n_workers,
        splits=tuple(splits),
        dists=dist_seq,
        samples=samples.cpu().numpy(),
        backend=device_name(dev),
    )


# ---------------------------------------------------------------------------
# batch completion of ONE placement: max-min and the coverage rule
# ---------------------------------------------------------------------------

# (trials, N, W) int64 words the coverage scan holds at once
_COVERAGE_CHUNK_WORDS = 1 << 25


def simulate_maxmin(
    dist: ServiceDistribution,
    n_workers: int,
    n_batches: int,
    n_trials: int = 20_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    device=None,
) -> SimResult:
    """Completion time of balanced non-overlapping replication, float64.

    Worker j serves batch ``j // r`` (``rates`` optional, length N); the
    completion is ``max_b min_{j in b} T_j`` of the shared draw matrix, so
    it equals the reference's float64 samples bit for bit.
    """
    if n_workers % n_batches:
        raise ValueError(f"B={n_batches} must divide N={n_workers}")
    r = n_workers // n_batches
    rates_arr = _validate_rates(rates, n_workers)
    dev = resolve_device(device)
    loads = np.full(n_workers, n_workers / n_batches)
    times = _draw_worker_times(dist, loads, n_trials, seed, rates_arr, dev)
    completion = times.reshape(n_trials, n_batches, r).amin(dim=2).amax(dim=1)
    return SimResult(completion.cpu().numpy())


def _pack_coverage(assignment: Assignment) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker coverage bitmasks: ``masks`` (N, W) uint64 with W =
    ceil(units/64), and ``full`` (W,) the all-units mask."""
    cov = assignment.coverage_matrix()  # (N, units) bool
    n, units = cov.shape
    words = (units + 63) // 64
    masks = np.zeros((n, words), dtype=np.uint64)
    full = np.zeros(words, dtype=np.uint64)
    for w in range(words):
        chunk = cov[:, w * 64 : (w + 1) * 64]
        weights = np.uint64(1) << np.arange(chunk.shape[1], dtype=np.uint64)
        masks[:, w] = (chunk.astype(np.uint64) * weights).sum(axis=1)
        full[w] = weights.sum()
    return masks, full


def _prefix_or(x: torch.Tensor) -> torch.Tensor:
    """Inclusive bitwise-OR scan of ``x`` (T, N, W) along N: log2(N)
    Hillis-Steele steps (torch has no cumulative OR)."""
    shift = 1
    while shift < x.shape[1]:
        x = torch.cat((x[:, :shift], x[:, shift:] | x[:, :-shift]), dim=1)
        shift *= 2
    return x


def simulate_coverage(
    dist: ServiceDistribution,
    assignment: Assignment,
    n_trials: int = 20_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    device=None,
) -> SimResult:
    """Completion time under the coverage rule for any assignment.

    The first time the union of finished workers' batches covers every
    data unit: sort each trial's float64 worker times, OR the sorted
    workers' coverage words cumulatively (:func:`_prefix_or`, in chunks of
    trials), and read the time of the first fully covered prefix.  Tied
    times cannot change that time, so it equals the reference's samples
    bit for bit.
    """
    loads = assignment.worker_load()
    rates_arr = _validate_rates(rates, assignment.n_workers)
    dev = resolve_device(device)
    times = _draw_worker_times(dist, loads, n_trials, seed, rates_arr, dev)
    masks, full = _pack_coverage(assignment)
    n, words = masks.shape
    masks_t = torch.as_tensor(masks.view(np.int64), device=dev)
    full_t = torch.as_tensor(full.view(np.int64), device=dev)
    sorted_times, order = torch.sort(times, dim=1)
    first = torch.empty(n_trials, dtype=torch.int64, device=dev)
    chunk = max(1, _COVERAGE_CHUNK_WORDS // (n * words))
    for lo in range(0, n_trials, chunk):
        cum = _prefix_or(masks_t[order[lo:lo + chunk]])
        # a prefix's union only grows: the first covered prefix's index is
        # the number of prefixes that do not cover
        first[lo:lo + chunk] = (cum != full_t).any(dim=2).sum(dim=1)
    completion = sorted_times.gather(1, first[:, None])[:, 0]
    return SimResult(completion.cpu().numpy())


def simulate_coverage_reference(
    dist: ServiceDistribution,
    assignment: Assignment,
    n_trials: int = 20_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    device=None,
) -> SimResult:
    """The oracle of :func:`simulate_coverage`: the same draws (made on
    ``device``), then a per-trial Python walk over the sorted workers on
    the host."""
    loads = assignment.worker_load()
    rates_arr = _validate_rates(rates, assignment.n_workers)
    times = _draw_worker_times(dist, loads, n_trials, seed, rates_arr,
                               resolve_device(device)).cpu().numpy()
    masks, full = _pack_coverage(assignment)
    order = np.argsort(times, axis=1)
    sorted_times = np.take_along_axis(times, order, axis=1)
    completion = np.empty(n_trials, dtype=float)
    for t in range(n_trials):
        acc = np.zeros_like(full)
        done_time = sorted_times[t, -1]
        for k in range(assignment.n_workers):
            acc |= masks[order[t, k]]
            if np.array_equal(acc, full):
                done_time = sorted_times[t, k]
                break
        completion[t] = done_time
    return SimResult(completion)


# ---------------------------------------------------------------------------
# coded-computation sweeps: (scheme, s) cells on the shared CRN draws
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodedSweepResult:
    """Samples for every (distribution, coding candidate) cell of a sweep.

    ``samples[d, c]`` holds completion (or post-warmup sojourn) times for
    ``dists[d]`` under ``candidates[c]``, from the SAME draw matrix a
    replication sweep at the same seed consumes.  Encode+decode overheads
    are already ADDED to every sample.  ``backend`` records the device.
    """

    n_workers: int
    candidates: tuple[CodingCandidate, ...]
    dists: tuple[ServiceDistribution, ...]
    samples: np.ndarray  # (n_dists, n_candidates, n_trials)
    backend: str

    def result(self, c_index: int, dist_index: int = 0) -> SimResult:
        return SimResult(self.samples[dist_index, c_index])

    def means(self) -> np.ndarray:
        """(n_dists, n_candidates) empirical mean completion times."""
        return self.samples.mean(axis=2)

    def best_mean(self, dist_index: int = 0) -> tuple[CodingCandidate, float]:
        m = self.means()[dist_index]
        c = int(np.argmin(m))
        return self.candidates[c], float(m[c])


def _coded_cell_stack(dist_seq, cands, unit, rates_arr, order, n_workers,
                      scale=1.0):
    """(D*C, T, N) float32 load-scaled worker-time cells (c = d*len(cands) +
    ci) and the per-cell quorum vector; float64 up to the cast."""
    n_c = len(cands)
    loads = [scale * c.load(n_workers) for c in cands]
    cells = torch.empty((len(dist_seq) * n_c, unit.shape[0], n_workers),
                        dtype=F32, device=unit.device)
    for di, dist in enumerate(dist_seq):
        core = _unit_times(unit, dist, rates_arr, order=order)
        for ci, load in enumerate(loads):
            cells[di * n_c + ci] = core * load
    ks = np.tile(
        np.asarray([c.k(n_workers) for c in cands], dtype=np.int32),
        len(dist_seq),
    )
    return cells, ks


def sweep_coded(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    candidates: Sequence[CodingCandidate],
    n_trials: int = 20_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    device=None,
) -> CodedSweepResult:
    """Batch-completion times of every (dist, coding candidate) cell.

    The coded twin of :func:`sweep_simulate` on the same draw matrix: a
    candidate's cell is the ``k``-th order statistic of the N per-worker
    times at its per-worker load (the ``coded_cells`` kernel, float32),
    plus its encode+decode overhead (float64).
    """
    dist_seq = _normalize_dists(dists)
    cands = _validate_coding_candidates(candidates, n_workers)
    rates_arr = _validate_rates(rates, n_workers)
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    unit = _draws(rng, (n_trials, n_workers), dev)
    order = _shared_draw_order(dist_seq, unit)
    cells, ks = _coded_cell_stack(dist_seq, cands, unit, rates_arr, order,
                                  n_workers)
    out = _ss.coded_completion_cells(cells, ks)
    samples = out.to(F64).cpu().numpy().reshape(
        len(dist_seq), len(cands), n_trials)
    overheads = np.asarray([c.total_overhead for c in cands])
    samples = samples + overheads[None, :, None]
    return CodedSweepResult(
        n_workers=n_workers,
        candidates=cands,
        dists=dist_seq,
        samples=samples,
        backend=device_name(dev),
    )


def sweep_sojourn_coded(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    candidates: Sequence[CodingCandidate],
    arrival_rate: float,
    n_jobs: int = 4_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
) -> CodedSweepResult:
    """Sojourn times of coded candidates under the queueing model.

    A coded job splits its ``job_load`` units across ALL N workers
    (per-worker load ``job_load * load / N``) and the fleet acts as ONE
    FIFO server whose service time is the job's k-th worker completion
    plus encode+decode overhead: ``coded_cells`` gives the service column,
    and ``sojourn_cells`` at G=1 runs the queue.  CRN-coupled to
    :func:`sweep_sojourn` at the same seed.
    """
    dist_seq = _normalize_dists(dists)
    cands = _validate_coding_candidates(candidates, n_workers)
    _validate_load(arrival_rate, job_load)
    rates_arr = _validate_rates(rates, n_workers)
    warm = _resolve_warmup(n_jobs, warmup)
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    arrivals = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    order = _shared_draw_order(dist_seq, unit)

    overheads = np.asarray([c.total_overhead for c in cands])
    n_c = len(cands)
    cells, ks = _coded_cell_stack(
        dist_seq, cands, unit, rates_arr, order, n_workers,
        scale=job_load / n_workers,
    )
    svc = _ss.coded_completion_cells(cells, ks)
    ovh = torch.as_tensor(np.tile(overheads, len(dist_seq)), device=dev)
    # (D*C, J, 1): one logical server; overhead added in float64, then the
    # float32 cast the reference applies
    svc = (svc.to(F64) + ovh[:, None]).to(F32)[:, :, None].contiguous()
    n_cells = svc.shape[0]
    out, _ = _ss.sojourn_policy_cells(
        torch.as_tensor(arrivals, device=dev), svc, svc,
        np.asarray([_ss.KIND_NONE], dtype=np.int32),
        np.full((n_cells, 1), np.inf), np.zeros((1, n_jobs), dtype=bool),
        np.ones(n_cells, dtype=np.int32),
    )
    samples = out[:, 0, warm:].to(F64).cpu().numpy().reshape(
        len(dist_seq), n_c, n_jobs - warm)
    return CodedSweepResult(
        n_workers=n_workers,
        candidates=cands,
        dists=dist_seq,
        samples=samples,
        backend=device_name(dev),
    )


# ---------------------------------------------------------------------------
# sojourn sweeps through the sojourn_cells kernel
# ---------------------------------------------------------------------------


# Group-min draw cache: the per-split (min, rank-of-min) reduction of a
# shared draw matrix depends only on (seed, shapes, splits, placement,
# device), NOT on the distributions being swept, so steady-state re-plans
# on the same seed skip it.
_GROUP_MIN_CACHE: dict = {}
_GROUP_MIN_CACHE_MAX = 4


def _group_min_draws(unit, splits, n_workers, worker_batches, want_rank,
                     cache_key):
    """Per-split group-minimum of the shared draw matrix, on its device.

    Returns ``(umin, rankmin)``: ``umin[s, j, g]`` is the minimum draw of
    job j over replica-set g at split ``splits[s]`` (+inf in padded slots)
    and ``rankmin`` its global rank in the flattened matrix (the input to
    empirical quantile coupling; ``None`` unless ``want_rank``).  Every
    supported transform is monotone per worker at uniform rates, so the
    group-argmin is distribution-independent.
    """
    ent = _GROUP_MIN_CACHE.get(cache_key)
    if ent is not None and (not want_rank or ent[1] is not None):
        return ent
    dev = unit.device
    n_jobs = unit.shape[0]
    gmax = max(splits)
    umin = torch.full((len(splits), n_jobs, gmax), float("inf"), dtype=F64,
                      device=dev)
    pos = (torch.zeros((len(splits), n_jobs, gmax), dtype=torch.int64,
                       device=dev) if want_rank else None)
    rows = torch.arange(n_jobs, device=dev)[:, None]
    for si, b in enumerate(splits):
        if worker_batches is None and not want_rank:
            r = n_workers // b
            umin[si, :, :b] = unit.reshape(n_jobs, b, r).amin(dim=2)
            continue
        if worker_batches is None:
            r = n_workers // b
            am = unit.reshape(n_jobs, b, r).argmin(dim=2)
            workers = torch.arange(b, device=dev)[None, :] * r + am
        else:
            wb = worker_batches[si]
            workers = torch.empty((n_jobs, b), dtype=torch.int64, device=dev)
            for g in range(b):
                members = np.flatnonzero(wb == g)
                if members.size == 0:
                    raise ValueError(f"replica-set {g} has no workers")
                mem = torch.as_tensor(members, device=dev)
                workers[:, g] = mem[unit[:, mem].argmin(dim=1)]
        umin[si, :, :b] = unit[rows, workers]
        if want_rank:
            pos[si, :, :b] = rows * n_workers + workers
    rankmin = None
    if want_rank:
        order = torch.sort(unit.reshape(-1), stable=True).indices
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=dev)
        rankmin = inv[pos.reshape(-1)].reshape(pos.shape)
    if len(_GROUP_MIN_CACHE) >= _GROUP_MIN_CACHE_MAX:
        _GROUP_MIN_CACHE.pop(next(iter(_GROUP_MIN_CACHE)))
    _GROUP_MIN_CACHE[cache_key] = (umin, rankmin)
    return umin, rankmin


def _hist_quantile(atoms: np.ndarray, cum: np.ndarray, q: float) -> float:
    """np.quantile('linear') of the multiset {atoms repeated by counts},
    evaluated through the cumulative-count histogram ``cum``."""
    m = int(cum[-1])
    h = q * (m - 1)
    lo = int(np.floor(h))
    hi = min(lo + 1, m - 1)
    v_lo = atoms[np.searchsorted(cum, lo, side="right")]
    v_hi = atoms[np.searchsorted(cum, hi, side="right")]
    return float(v_lo + (v_hi - v_lo) * (h - lo))


def _host_quantiles(x: torch.Tensor, quantiles) -> dict:
    """``{q: np.quantile(x, q)}`` of a device tensor, on the host.

    One ``np.quantile`` call takes every ``q`` at once: numpy evaluates the
    linear rule elementwise over the quantiles and partitions at every
    needed index in one pass, so each value is the one a separate call per
    ``q`` gives, for half the partition work at two quantiles.
    """
    vals = np.quantile(x.cpu().numpy(), quantiles)
    return {q: v for q, v in zip(quantiles, vals)}


def _policy_cell_tensors(
    dist_seq, splits, pol_seq, unit, alt_unit, rates_arr, job_load,
    n_workers, worker_batches, cache_key,
):
    """Materialize the (cell, job, group) service tensors for the kernel.

    Returns ``(svc, alt, thresholds, n_groups)`` with cells ordered
    ``c = dist_index * len(splits) + split_index``: ``svc``/``alt`` are
    float32 ``(D*S, J, Gmax)`` device tensors (``alt`` is None when
    ``alt_unit`` is), ``thresholds`` a float64 host array ``(D*S, P)`` of
    trigger delays (inf = disabled), ``n_groups`` int32 ``(D*S,)``.  The
    thresholds are ``np.quantile`` of the float64 group minima on the host
    (or the histogram quantile for uniform-weight Empirical dists), exactly
    as the reference computes them.
    """
    dev = unit.device
    n_jobs = unit.shape[0]
    gmax = max(splits)
    n_d, n_s, n_p = len(dist_seq), len(splits), len(pol_seq)
    quantiles = sorted(
        {p.quantile for p in pol_seq
         if p.kind in ("clone", "relaunch") and p.quantile is not None}
    )
    svc = torch.zeros((n_d * n_s, n_jobs, gmax), dtype=F32, device=dev)
    alt = torch.zeros_like(svc) if alt_unit is not None else None
    thresholds = np.full((n_d * n_s, n_p), np.inf)
    n_groups = np.tile(np.asarray(splits, dtype=np.int32), n_d)

    def _fill_thresholds(c, thr_by_q):
        for pi, p in enumerate(pol_seq):
            if p.kind in ("clone", "relaunch") and p.quantile is not None:
                thresholds[c, pi] = thr_by_q[p.quantile]

    def _coupled(dist, rank):
        """Empirical cell from the ranks of the group minima (float64)."""
        if dist.weights is None:
            idx = (2 * rank + 1) * dist.n_atoms // (2 * m_total)
            return _atoms(dist, dev)[idx] * job_load, idx
        levels = _div(2.0 * rank.to(F64) + 1.0, 2.0 * m_total)
        cell = _ppf(dist, levels.reshape(-1)).reshape(levels.shape)
        return cell * job_load, None

    m_total = n_jobs * n_workers
    if rates_arr is None:
        has_emp = any(isinstance(d, Empirical) for d in dist_seq)
        key = cache_key + (str(dev),)
        with _stage("group_min"):
            umin, rankmin = _group_min_draws(
                unit, splits, n_workers, worker_batches, has_emp,
                key + ("primary",),
            )
            aumin = arank = None
            if alt_unit is not None:
                aumin, arank = _group_min_draws(
                    alt_unit, splits, n_workers, worker_batches, has_emp,
                    key + ("alt",),
                )
        # distribution-independent per-split quantiles, on the host
        with _stage("thresholds"):
            uq = {si: _host_quantiles(umin[si, :, :b], quantiles)
                  for si, b in enumerate(splits)} if quantiles else {}
        hists: dict = {}
        with _stage("cells"):
            for si, b in enumerate(splits):
                for di, dist in enumerate(dist_seq):
                    c = di * n_s + si
                    if isinstance(dist, Empirical):
                        cell, idx = _coupled(dist, rankmin[si, :, :b])
                        if quantiles and idx is not None:
                            n_at = dist.n_atoms
                            if (si, n_at) not in hists:
                                hists[si, n_at] = np.cumsum(torch.bincount(
                                    idx.reshape(-1), minlength=n_at
                                ).cpu().numpy())
                            cum = hists[si, n_at]
                            _fill_thresholds(c, {
                                q: _hist_quantile(dist._atoms_arr, cum, q)
                                * job_load for q in quantiles})
                        elif quantiles:
                            _fill_thresholds(
                                c, _host_quantiles(cell, quantiles))
                        svc[c, :, :b] = cell
                        if alt is not None:
                            alt[c, :, :b] = _coupled(dist, arank[si, :, :b])[0]
                    else:
                        shift, mu = _dist_params(dist)
                        svc[c, :, :b] = (
                            shift + _div(umin[si, :, :b], mu)) * job_load
                        if alt is not None:
                            alt[c, :, :b] = (
                                shift + _div(aumin[si, :, :b], mu)) * job_load
                        _fill_thresholds(c, {
                            q: (shift + uq[si][q] / mu) * job_load
                            for q in quantiles})
        return svc, alt, thresholds, n_groups

    # skewed rates: full per-dist core materialization (correctness path)
    with _stage("cells"):
        order = _shared_draw_order(dist_seq, unit)
        alt_order = (_shared_draw_order(dist_seq, alt_unit)
                     if alt_unit is not None else None)
        for di, dist in enumerate(dist_seq):
            core = _unit_times(unit, dist, rates_arr, order=order) * job_load
            alt_core = (_unit_times(alt_unit, dist, rates_arr, order=alt_order)
                        * job_load if alt_unit is not None else None)
            for si, b in enumerate(splits):
                c = di * n_s + si
                if worker_batches is None:
                    r = n_workers // b
                    cell = core.reshape(n_jobs, b, r).amin(dim=2)
                    if alt_core is not None:
                        alt[c, :, :b] = alt_core.reshape(
                            n_jobs, b, r).amin(dim=2)
                else:
                    cell = _group_min_times(core, worker_batches[si], b)
                    if alt_core is not None:
                        alt[c, :, :b] = _group_min_times(
                            alt_core, worker_batches[si], b)
                svc[c, :, :b] = cell
                if quantiles:
                    _fill_thresholds(c, _host_quantiles(cell, quantiles))
    return svc, alt, thresholds, n_groups


def _sweep_policies_accel(
    dist_seq, splits, pol_seq, arr, unit, alt_unit, rates_arr, job_load,
    n_workers, warm, worker_batches, cache_key,
):
    """Run a (dist, B, policy) sweep through the ``sojourn_cells`` kernel.

    One dispatch for the whole sweep: every (dist, split) cell, padded to
    the widest split, under every policy.  Each program reads only its own
    cell's sets, and only programs whose policy can arm a trigger resolve
    events.  Returns ``(samples (D, S, P, J-warm) f64, extra_fraction
    (D, S, P))``.
    """
    dev = unit.device
    n_jobs = unit.shape[0]
    svc, alt, thresholds, n_groups = _policy_cell_tensors(
        dist_seq, splits, pol_seq, unit, alt_unit, rates_arr, job_load,
        n_workers, worker_batches, cache_key,
    )
    kinds = np.array([_ss.policy_kind_code(p.kind) for p in pol_seq],
                     dtype=np.int32)
    hmasks = np.stack([
        _ss.hedge_mask(n_jobs, p.hedge_fraction if p.kind == "hedged" else 0.0)
        for p in pol_seq
    ])
    n_d, n_s, n_p = len(dist_seq), len(splits), len(pol_seq)
    arr_t = torch.as_tensor(arr, device=dev)
    with _stage("scan"):
        out, x = _ss.sojourn_policy_cells(
            arr_t, svc, alt if alt is not None else svc, kinds, thresholds,
            hmasks, n_groups,
        )
        samples = out.to(F64).cpu().numpy().reshape(n_d, n_s, n_p, n_jobs)
        extras = x.cpu().numpy().astype(float).reshape(n_d, n_s, n_p)
    return samples[..., warm:], extras / n_jobs


def sweep_sojourn(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    arrival_rate: float,
    n_jobs: int = 4_000,
    seed: int = 0,
    feasible_b: Sequence[int] | None = None,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
    worker_batches: Sequence[Sequence[int]] | None = None,
) -> SweepSimResult:
    """Sojourn times for ALL feasible (B, r) splits x distributions.

    The queueing twin of :func:`sweep_simulate`: ONE shared arrival
    sequence and ONE shared (n_jobs, N) draw matrix feed every cell, each
    a FIFO M/G/B scan on the ``sojourn_cells`` kernel (policy 'none').
    ``arrivals`` overrides the Poisson arrival sequence with explicit
    offsets (cycled to ``n_jobs``); ``worker_batches`` overrides the
    contiguous worker->set grouping per split.
    """
    dist_seq = _normalize_dists(dists)
    splits, wbs = _resolve_splits(n_workers, feasible_b, worker_batches)
    _validate_load(arrival_rate, job_load)
    rates_arr = _validate_rates(rates, n_workers)
    warm = _resolve_warmup(n_jobs, warmup)
    dev = resolve_device(device)
    arrivals_given = arrivals is not None

    rng = np.random.default_rng(seed)
    arrivals = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    cache_key = ("sojourn", seed, n_jobs, n_workers, arrivals_given,
                 tuple(splits), _wb_cache_tag(wbs))
    accel, _ = _sweep_policies_accel(
        dist_seq, splits, (PolicyCandidate("none"),), arrivals, unit,
        None, rates_arr, job_load, n_workers, warm, wbs, cache_key,
    )
    return SweepSimResult(
        n_workers=n_workers,
        splits=tuple(splits),
        dists=dist_seq,
        samples=accel[:, :, 0, :],
        backend=device_name(dev),
    )


@dataclasses.dataclass(frozen=True)
class SpeculativeSweepResult:
    """Sojourn samples for every (distribution, B, late-quantile) cell.

    ``samples[d, s, q]`` holds the post-warmup sojourns of ``dists[d]`` at
    ``splits[s]`` batches under the clone trigger ``quantiles[q]`` (``None``
    = no speculation); ``clone_fraction[d, s, q]`` is the fraction of jobs
    that launched a clone.  ``backend`` records the device.
    """

    n_workers: int
    splits: tuple[int, ...]
    quantiles: tuple[float | None, ...]
    dists: tuple[ServiceDistribution, ...]
    samples: np.ndarray  # (n_dists, n_splits, n_quantiles, n_jobs - warmup)
    clone_fraction: np.ndarray  # (n_dists, n_splits, n_quantiles)
    backend: str = "cuda"

    def result(self, n_batches: int, quantile: float | None,
               dist_index: int = 0) -> SimResult:
        return SimResult(
            self.samples[
                dist_index,
                self.splits.index(n_batches),
                self.quantiles.index(quantile),
            ]
        )


def sweep_sojourn_speculative(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    arrival_rate: float,
    quantiles: Sequence[float | None],
    n_jobs: int = 4_000,
    seed: int = 0,
    feasible_b: Sequence[int] | None = None,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
) -> SpeculativeSweepResult:
    """Sojourns for ALL (B, speculation-quantile) pairs x distributions.

    Each quantile maps to its equivalent ``PolicyCandidate('clone', q)``
    cell (``None`` to the plain cell); every cell shares one arrival
    sequence, one primary draw matrix and one clone draw matrix.
    """
    dist_seq = _normalize_dists(dists)
    splits, _ = _resolve_splits(n_workers, feasible_b)
    q_seq = tuple(quantiles)
    if not q_seq:
        raise ValueError("at least one speculation quantile required")
    _validate_quantiles(q_seq)
    _validate_load(arrival_rate, job_load)
    rates_arr = _validate_rates(rates, n_workers)
    warm = _resolve_warmup(n_jobs, warmup)
    dev = resolve_device(device)
    arrivals_given = arrivals is not None

    rng = np.random.default_rng(seed)
    arrivals = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    clone_unit = _draws(rng, (n_jobs, n_workers), dev)
    pol_seq = tuple(_trigger_policy(q) for q in q_seq)
    cache_key = ("sojourn", seed, n_jobs, n_workers, arrivals_given,
                 tuple(splits), None)
    samples, clones = _sweep_policies_accel(
        dist_seq, splits, pol_seq, arrivals, unit, clone_unit, rates_arr,
        job_load, n_workers, warm, None, cache_key,
    )
    return SpeculativeSweepResult(
        n_workers=n_workers,
        splits=tuple(splits),
        quantiles=q_seq,
        dists=dist_seq,
        samples=samples,
        clone_fraction=clones,
        backend=device_name(dev),
    )


@dataclasses.dataclass(frozen=True)
class PolicySweepResult:
    """Sojourn samples for every (distribution, B, policy) cell.

    ``samples[d, s, p]`` holds the post-warmup sojourns of ``dists[d]`` at
    ``splits[s]`` batches under ``policies[p]``; ``extra_fraction[d, s,
    p]`` is the fraction of jobs that launched an extra intervention
    (clone, relaunch, or hedge).  ``backend`` records the device.
    """

    n_workers: int
    splits: tuple[int, ...]
    policies: tuple[PolicyCandidate, ...]
    dists: tuple[ServiceDistribution, ...]
    samples: np.ndarray  # (n_dists, n_splits, n_policies, n_jobs - warmup)
    extra_fraction: np.ndarray  # (n_dists, n_splits, n_policies)
    backend: str = "cuda"

    def result(self, n_batches: int, policy: PolicyCandidate,
               dist_index: int = 0) -> SimResult:
        return SimResult(
            self.samples[
                dist_index,
                self.splits.index(n_batches),
                self.policies.index(policy),
            ]
        )


def sweep_sojourn_policies(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    arrival_rate: float,
    policies: Sequence[PolicyCandidate],
    n_jobs: int = 4_000,
    seed: int = 0,
    feasible_b: Sequence[int] | None = None,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
    worker_batches: Sequence[Sequence[int]] | None = None,
) -> PolicySweepResult:
    """Sojourns for ALL (B, straggler-policy) pairs x distributions.

    The planner's scoring engine for the policy portfolio: every cell
    shares ONE arrival sequence, ONE primary draw matrix and ONE alternate
    draw matrix, and every (dist, B, policy) cell runs on the
    ``sojourn_cells`` kernel in one dispatch for the whole sweep.
    """
    dist_seq = _normalize_dists(dists)
    splits, wbs = _resolve_splits(n_workers, feasible_b, worker_batches)
    pol_seq = _validate_policies(policies)
    _validate_load(arrival_rate, job_load)
    rates_arr = _validate_rates(rates, n_workers)
    warm = _resolve_warmup(n_jobs, warmup)
    dev = resolve_device(device)
    arrivals_given = arrivals is not None

    rng = np.random.default_rng(seed)
    arr = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    alt_unit = _draws(rng, (n_jobs, n_workers), dev)
    cache_key = ("sojourn", seed, n_jobs, n_workers, arrivals_given,
                 tuple(splits), _wb_cache_tag(wbs))
    samples, extra = _sweep_policies_accel(
        dist_seq, splits, pol_seq, arr, unit, alt_unit, rates_arr,
        job_load, n_workers, warm, wbs, cache_key,
    )
    return PolicySweepResult(
        n_workers=n_workers,
        splits=tuple(splits),
        policies=pol_seq,
        dists=dist_seq,
        samples=samples,
        extra_fraction=extra,
        backend=device_name(dev),
    )


# ---------------------------------------------------------------------------
# sojourns of ONE (B, placement): the rate-aware planner's per-B path
# ---------------------------------------------------------------------------


def _resolve_sojourn_args(
    n_workers, n_batches, arrival_rate, quantiles,
    n_jobs, rates, job_load, warmup, worker_batch,
):
    """Shared validation + worker->set map of the per-B sojourn entry
    points: ``(wb, rates_arr, warmup)``."""
    _validate_load(arrival_rate, job_load)
    _validate_quantiles(quantiles)
    if worker_batch is None:
        if n_workers % n_batches:
            raise ValueError(f"B={n_batches} must divide N={n_workers}")
        wb = np.arange(n_workers) // (n_workers // n_batches)
    else:
        wb = np.asarray(worker_batch, dtype=int)
        if wb.shape != (n_workers,):
            raise ValueError(f"worker_batch shape {wb.shape} != ({n_workers},)")
    return wb, _validate_rates(rates, n_workers), _resolve_warmup(n_jobs, warmup)


def _per_b_sojourns(dist, n_workers, n_batches, arrival_rate, pol_seq, n_jobs,
                    seed, rates_arr, job_load, warm, wb, worker_batch,
                    arrivals, device) -> list[np.ndarray]:
    """Post-warmup sojourns of one (B, placement) under every policy: one
    ``sojourn_cells`` launch (a single-cell call of the sweeps' seam).

    Draws in the reference's order: arrivals, the primary matrix, then the
    alternate matrix only when some policy is not ``'none'``, so a later
    draw from the same seed is the reference's too.  The group-minima
    cache key carries the placement.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    arr = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    alt_unit = (_draws(rng, (n_jobs, n_workers), dev)
                if any(p.kind != "none" for p in pol_seq) else None)
    wbs = None if worker_batch is None else (wb,)
    cache_key = ("sojourn", seed, n_jobs, n_workers, arrivals is not None,
                 (n_batches,), _wb_cache_tag(wbs))
    samples, _ = _sweep_policies_accel(
        (dist,), [n_batches], pol_seq, arr, unit, alt_unit, rates_arr,
        job_load, n_workers, warm, wbs, cache_key,
    )
    return [samples[0, 0, pi] for pi in range(len(pol_seq))]


def simulate_sojourn(
    dist: ServiceDistribution,
    n_workers: int,
    n_batches: int,
    arrival_rate: float,
    n_jobs: int = 4_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    worker_batch: Sequence[int] | None = None,
    speculation_quantile: float | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
) -> SimResult:
    """Sojourn times of one (B, r) split under Poisson batch-job arrivals.

    ``worker_batch`` supplies the worker -> set map (default: contiguous
    ``j // r``); ``speculation_quantile`` switches on the clone trigger at
    that quantile of the set-service times (its alternate draws are made
    only then); ``arrivals`` overrides the Poisson sequence.  The first
    ``warmup`` jobs (default 10%) are dropped.  One ``sojourn_cells``
    launch, float32.
    """
    wb, rates_arr, warm = _resolve_sojourn_args(
        n_workers, n_batches, arrival_rate, (speculation_quantile,),
        n_jobs, rates, job_load, warmup, worker_batch,
    )
    samples = _per_b_sojourns(
        dist, n_workers, n_batches, arrival_rate,
        (_trigger_policy(speculation_quantile),), n_jobs, seed, rates_arr,
        job_load, warm, wb, worker_batch, arrivals, device,
    )
    return SimResult(samples[0])


def simulate_sojourn_quantiles(
    dist: ServiceDistribution,
    n_workers: int,
    n_batches: int,
    arrival_rate: float,
    quantiles: Sequence[float | None],
    n_jobs: int = 4_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    worker_batch: Sequence[int] | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
) -> list[np.ndarray]:
    """Sojourn samples of ONE (B, placement) at several clone triggers
    (``None`` = none), from one arrival sequence, draw matrix and clone
    matrix: entry ``k`` is bit-equal to ``simulate_sojourn(...,
    speculation_quantile=quantiles[k])`` at the same seed."""
    wb, rates_arr, warm = _resolve_sojourn_args(
        n_workers, n_batches, arrival_rate, quantiles,
        n_jobs, rates, job_load, warmup, worker_batch,
    )
    return _per_b_sojourns(
        dist, n_workers, n_batches, arrival_rate,
        tuple(_trigger_policy(q) for q in quantiles), n_jobs, seed,
        rates_arr, job_load, warm, wb, worker_batch, arrivals, device,
    )


def simulate_sojourn_policies(
    dist: ServiceDistribution,
    n_workers: int,
    n_batches: int,
    arrival_rate: float,
    policies: Sequence[PolicyCandidate],
    n_jobs: int = 4_000,
    seed: int = 0,
    rates: Sequence[float] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    worker_batch: Sequence[int] | None = None,
    arrivals: Sequence[float] | None = None,
    device=None,
) -> list[np.ndarray]:
    """Sojourn samples of ONE (B, placement) under several straggler
    policies: the per-B path of the rate-aware planner.  Every candidate
    shares one arrival sequence, primary matrix and (only when some
    candidate is not ``'none'``) alternate matrix; one ``sojourn_cells``
    launch scores them all."""
    pol_seq = _validate_policies(policies)
    wb, rates_arr, warm = _resolve_sojourn_args(
        n_workers, n_batches, arrival_rate, (None,),
        n_jobs, rates, job_load, warmup, worker_batch,
    )
    return _per_b_sojourns(
        dist, n_workers, n_batches, arrival_rate, pol_seq, n_jobs, seed,
        rates_arr, job_load, warm, wb, worker_batch, arrivals, device,
    )


# ---------------------------------------------------------------------------
# multi-tenant serving sweep: (B, policy, max_wait, shed) x classes
# ---------------------------------------------------------------------------

# Admission throttle depth for ShedPolicy('cap') formation: a new batch only
# forms while the fluid job backlog is below this many jobs PER replica-set
# (q_max = depth * B), so overload waits in the admission queue — where the
# queue cap and weight-aware eviction can see it — instead of in an
# unbounded formed-batch buffer.
_THROTTLE_DEPTH = 2.0


def _mean_min_service(dist: ServiceDistribution, r: int, job_load: float):
    """Closed-form mean of one replica-set's service (min over ``r``
    replicas) — the drain-rate anchor of the 'cap' admission throttle.

    ``scaled(s) = s*shift + Exp(1)*s/mu`` makes the min over ``r`` i.i.d.
    replicas ``s*shift + Exp(1)*s/(r*mu)``, so the mean is exact for every
    mu-exposing distribution (the only kind the serving sweep accepts).
    """
    shift, mu = _dist_params(dist)
    return (float(shift) + 1.0 / (r * float(mu))) * float(job_load)


def _sample_metric(samples: np.ndarray, metric: str) -> float:
    """Objective metric of a latency sample vector (the serving twin of
    :func:`repro_torch.core.spectrum.metric_value`, which reads precomputed
    spectrum points — same four-literal vocabulary)."""
    s = np.asarray(samples, dtype=float)
    if metric == "mean":
        return float(s.mean())
    if metric == "var":
        return float(s.var(ddof=1)) if s.size > 1 else 0.0
    if metric == "p99":
        return float(np.quantile(s, 0.99))
    if metric == "p999":
        return float(np.quantile(s, 0.999))
    raise ValueError(
        f"unknown metric {metric!r} (expected 'mean'|'var'|'p99'|'p999')"
    )


def _validate_classes(slo_classes) -> tuple[SloClass, ...]:
    classes = tuple(slo_classes)
    if not classes:
        raise ValueError("at least one SloClass is required")
    if not all(isinstance(c, SloClass) for c in classes):
        raise TypeError(f"slo_classes must be SloClass instances: {classes}")
    if len({c.name for c in classes}) != len(classes):
        raise ValueError(f"duplicate class names in {classes}")
    return classes


def _form_schedule(
    arrivals: np.ndarray,
    class_idx: np.ndarray,
    names: Sequence[str],
    weights: np.ndarray,
    batch_size: int,
    max_wait: float,
    shed: ShedPolicy,
    deadlines: np.ndarray,
    drain_rate: float | None = None,
    q_max: float = math.inf,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic request->batch formation pre-pass of the serving sweep.

    Replays the event-driven master's admission + formation layer on one
    request trace, WITHOUT service draws — formation is arrival-driven, so
    the job stream it produces is shared by every (dist, B, policy) cell of
    the same (max_wait, shed) combo.  It is sequential host logic (each
    arrival's fate depends on the queue every earlier one left), so it
    stays a plain loop on the host:

    * WFQ admission: per-class FIFO lanes, stride-scheduled by ``weights``
      (pass += 1/weight per pop, ties by (pass, oldest arrival, name); an
      idle class re-joins at the scheduler's virtual time) — one class
      degenerates to plain FIFO;
    * a batch forms when ``batch_size`` requests wait, or when the OLDEST
      queued request has waited ``max_wait`` (whichever first); leftovers
      flush at the end of the stream;
    * ``shed.kind == 'expired'``: requests past their deadline are shed at
      admission or at the formation boundary;
    * ``shed.kind == 'cap'``: formation is throttled against a fluid drain
      model of the replica-set fabric (``drain_rate`` jobs/time; a batch
      only forms while the fluid backlog is below ``q_max`` jobs — the
      ``max_wait`` timer bypasses the throttle, so the oldest-waiting bound
      still holds), and an arrival finding ``shed.cap`` requests queued is
      shed — or, when it belongs to a strictly heavier class, evicts the
      NEWEST request of the cheapest backlogged class (ties by (weight,
      name)) instead.

    Returns ``(formed, req_job)``: ``formed[j]`` is job ``j``'s formation
    time (non-decreasing) and ``req_job[i]`` the job serving request ``i``
    (−1 = shed).
    """
    n_req = len(arrivals)
    req_job = np.full(n_req, -1, dtype=np.int64)
    formed: list[float] = []
    n_classes = len(names)
    lanes: list[deque] = [deque() for _ in range(n_classes)]
    lane_pass = [0.0] * n_classes
    vclock = 0.0
    n_queued = 0
    cap = shed.cap if shed.kind == "cap" else None
    expire = shed.kind == "expired"
    throttled = drain_rate is not None
    vj = 0.0  # fluid job backlog (throttled formation only)
    t_fluid = 0.0

    def drain(t: float) -> None:
        nonlocal vj, t_fluid
        if throttled:
            vj = max(0.0, vj - (t - t_fluid) * drain_rate)
            t_fluid = t

    def oldest() -> float:
        return min(
            (arrivals[ln[0]] for ln in lanes if ln), default=math.inf
        )

    def pop_one() -> int:
        nonlocal vclock, n_queued
        best = best_c = None
        for c in range(n_classes):
            if not lanes[c]:
                continue
            key = (lane_pass[c], arrivals[lanes[c][0]], names[c])
            if best is None or key < best:
                best, best_c = key, c
        i = lanes[best_c].popleft()
        vclock = lane_pass[best_c]
        lane_pass[best_c] += 1.0 / weights[best_c]
        n_queued -= 1
        return i

    def form(k: int, t: float) -> None:
        nonlocal vj
        members = []
        for _ in range(k):
            i = pop_one()
            if expire and deadlines[i] < t:
                continue  # shed at the formation boundary (req_job stays -1)
            members.append(i)
        if not members:
            return  # everything popped was dead work
        j = len(formed)
        for i in members:
            req_job[i] = j
        formed.append(t)
        if throttled:
            vj += 1.0

    def evict_for(i: int) -> bool:
        """Weight-aware cap shedding: evict the NEWEST request of the
        cheapest backlogged class when it weighs strictly less than the
        arrival's class; return whether a slot was freed."""
        nonlocal n_queued
        best = best_c = None
        for c in range(n_classes):
            if not lanes[c]:
                continue
            key = (weights[c], names[c])
            if best is None or key < best:
                best, best_c = key, c
        if best is None or best[0] >= weights[class_idx[i]]:
            return False
        lanes[best_c].pop()  # req_job of the victim stays -1
        n_queued -= 1
        return True

    def next_due() -> tuple[float, bool]:
        """(time, is_size) of the next formation: the throttle's release
        when a full batch waits, else the oldest request's timer."""
        t_timer = oldest() + max_wait if n_queued else math.inf
        t_size = math.inf
        if throttled and n_queued >= batch_size:
            t_size = t_fluid + max(0.0, vj - (q_max - 1.0)) / drain_rate
        return (t_size, True) if t_size <= t_timer else (t_timer, False)

    for i in range(n_req):
        t = arrivals[i]
        # fire formations due before this arrival (throttle releases and
        # oldest-waiting max_wait timers, in event order)
        while n_queued:
            tn, is_size = next_due()
            if tn > t:
                break
            drain(tn)
            form(batch_size if is_size else min(n_queued, batch_size), tn)
        drain(t)
        if expire and deadlines[i] < t:
            continue  # already expired at admission: never queue dead work
        if cap is not None and n_queued >= cap and not evict_for(i):
            continue  # admission-control shedding: the queue is at capacity
        c = class_idx[i]
        if not lanes[c]:
            # a class (re)activating joins at the current virtual time
            lane_pass[c] = max(lane_pass[c], vclock)
        lanes[c].append(i)
        n_queued += 1
        if n_queued >= batch_size and (not throttled or vj + 1.0 <= q_max):
            form(batch_size, t)
    # end of stream: flush leftovers (timer / throttle-release instants
    # when finite, else in max-batch chunks at the last arrival)
    t_end = float(arrivals[-1]) if n_req else 0.0
    while n_queued:
        tn, is_size = next_due()
        if not math.isfinite(tn):
            tn, is_size = max(t_end, t_fluid), False
        drain(tn)
        form(batch_size if is_size else min(n_queued, batch_size), tn)
    return np.asarray(formed, dtype=float), req_job


@dataclasses.dataclass(frozen=True)
class ServingSweepResult:
    """Per-request latencies for every (dist, B, policy, max_wait, shed)
    serving cell under multi-tenant classes.

    The request-level twin of :class:`PolicySweepResult`: every cell shares
    ONE request arrival trace, ONE class labeling, ONE primary draw matrix
    and ONE alternate draw matrix (common random numbers), so comparisons
    across all five axes measure pure configuration effect.  Cells of one
    (max_wait, shed) combo also share the formation pre-pass; a cell's jobs
    draw rows ``[:J]`` of the shared matrices, so cells of different combos
    stay CRN-coupled through the common prefix.

    Ragged storage (``J`` varies per combo): ``formed[d][s][w][h]`` is the
    (J,) job formation times, ``samples[d][s][w][h]`` the (P, J) job
    sojourns (float32 from the device, held as float64),
    ``req_job[d, s, w, h]`` the request->job map (−1 = shed),
    ``extra_fraction[d, s, p, w, h]`` the per-job straggler-policy work
    price.  Scoring is float64 numpy on the host, request-level:
    :meth:`request_latency` maps job sojourns back onto requests (formation
    wait + job sojourn; NaN = shed), :meth:`class_miss_rates` folds sheds +
    deadline misses per class, and :meth:`weighted_metric` /
    :meth:`feasible` are what the planner ranks.  Requests ``< warmup`` are
    simulated but excluded from scoring.  ``backend`` records the device.
    """

    n_workers: int
    batch_size: int
    splits: tuple[int, ...]
    policies: tuple[PolicyCandidate, ...]
    max_waits: tuple[float, ...]
    sheds: tuple[ShedPolicy, ...]
    dists: tuple[ServiceDistribution, ...]
    classes: tuple[SloClass, ...]
    request_arrivals: np.ndarray  # (R,)
    request_class: np.ndarray  # (R,) index into classes
    deadlines: np.ndarray  # (R,) ABSOLUTE deadline (inf = none)
    warmup: int
    formed: tuple  # [d][s][w][h] -> (J,) job formation times
    req_job: np.ndarray  # (D, S, W, H, R) job index, -1 = shed
    samples: tuple  # [d][s][w][h] -> (P, J) job sojourns
    extra_fraction: np.ndarray  # (D, S, P, W, H)
    backend: str = "cuda"

    def request_latency(self, di, si, pi, wi, hi) -> np.ndarray:
        """(R,) per-request latency (formation wait + job sojourn) of one
        cell; NaN marks shed requests."""
        rj = self.req_job[di, si, wi, hi]
        lat = np.full(rj.shape, np.nan)
        served = rj >= 0
        jobs = rj[served]
        lat[served] = (
            self.formed[di][si][wi][hi][jobs]
            - self.request_arrivals[served]
            + self.samples[di][si][wi][hi][pi][jobs]
        )
        return lat

    def _post_warm(self) -> np.ndarray:
        mask = np.zeros(len(self.request_arrivals), dtype=bool)
        mask[self.warmup:] = True
        return mask

    def class_shed_fractions(self, di, si, wi, hi) -> np.ndarray:
        """(C,) post-warmup shed fraction per class (policy-independent:
        shedding happens at admission/formation, before any draw)."""
        shed = (self.req_job[di, si, wi, hi] < 0) & self._post_warm()
        out = np.zeros(len(self.classes))
        for ci in range(len(self.classes)):
            sel = (self.request_class == ci) & self._post_warm()
            out[ci] = shed[sel].mean() if sel.any() else 0.0
        return out

    def class_miss_rates(self, di, si, pi, wi, hi) -> np.ndarray:
        """(C,) post-warmup deadline-miss rate per class: shed requests and
        served-past-deadline requests both count; classes without a
        deadline report NaN (no miss concept)."""
        lat = self.request_latency(di, si, pi, wi, hi)
        post = self._post_warm()
        out = np.full(len(self.classes), np.nan)
        for ci, cls in enumerate(self.classes):
            if cls.deadline is None:
                continue
            sel = (self.request_class == ci) & post
            if not sel.any():
                out[ci] = 0.0
                continue
            rel = self.deadlines[sel] - self.request_arrivals[sel]
            miss = np.isnan(lat[sel]) | (lat[sel] > rel)
            out[ci] = miss.mean()
        return out

    def feasible(self, di, si, pi, wi, hi) -> bool:
        """True when every class with a ``miss_target`` meets it."""
        rates = self.class_miss_rates(di, si, pi, wi, hi)
        for ci, cls in enumerate(self.classes):
            if cls.miss_target is not None and rates[ci] > cls.miss_target:
                return False
        return True

    def weighted_metric(self, di, si, pi, wi, hi, metric: str) -> float:
        """Weight-averaged per-class latency metric of one cell, over
        SERVED post-warmup requests (shed requests are priced by
        :meth:`class_miss_rates` / :meth:`feasible`, not here; a class with
        no served sample drops out of the average)."""
        lat = self.request_latency(di, si, pi, wi, hi)
        post = self._post_warm()
        total = value = 0.0
        for ci, cls in enumerate(self.classes):
            sel = (self.request_class == ci) & post & ~np.isnan(lat)
            if not sel.any():
                continue
            value += cls.weight * _sample_metric(lat[sel], metric)
            total += cls.weight
        return value / total if total else math.inf


def _serving_common(
    dists, n_workers, request_rate, batch_size, slo_classes, policies,
    max_waits, sheds, n_requests, seed, job_load, warmup, arrivals,
    class_labels, device,
):
    """Shared validation + CRN draw block of the serving sweep and its
    standalone companion.  RNG consumption order (the parity contract):
    request arrivals first (unless given), then class labels (unless
    given), then the primary draw matrix, then the alternate matrix —
    always all four, so draws are axis- and device-independent.  The two
    matrices are moved to ``device``; the trace stays on the host."""
    dist_seq = _normalize_dists(dists)
    for d in dist_seq:
        if isinstance(d, Empirical):
            raise TypeError(
                "the serving sweep requires mu-exposing distributions "
                "(Exp/SExp); Empirical is not supported on this path"
            )
    classes = _validate_classes(slo_classes)
    pol_seq = _validate_policies(policies)
    _validate_load(request_rate, job_load)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    mw_seq = tuple(float(w) for w in max_waits)
    if not mw_seq or any(not w > 0 for w in mw_seq):
        raise ValueError(f"max_waits must be positive, got {max_waits}")
    shed_seq = tuple(sheds)
    if not shed_seq or not all(isinstance(s, ShedPolicy) for s in shed_seq):
        raise TypeError(f"sheds must be ShedPolicy instances: {sheds}")
    warm = _resolve_warmup(n_requests, warmup)

    rng = np.random.default_rng(seed)
    arr_req = _resolve_arrivals(arrivals, n_requests, request_rate, rng)
    names = tuple(c.name for c in classes)
    if class_labels is None:
        shares = np.array([c.share for c in classes], dtype=float)
        cum = np.cumsum(shares / shares.sum())
        cls_idx = np.minimum(
            np.searchsorted(cum, rng.random(n_requests), side="right"),
            len(classes) - 1,
        ).astype(np.int64)
    else:
        by_name = {n: i for i, n in enumerate(names)}
        try:
            cls_idx = np.array(
                [by_name[str(c)] for c in class_labels], dtype=np.int64
            )
        except KeyError as e:
            raise ValueError(f"unknown class label {e.args[0]!r}") from None
        if len(cls_idx) != n_requests:
            raise ValueError(
                f"class_labels has {len(cls_idx)} entries for "
                f"{n_requests} requests"
            )
    unit = _draws(rng, (n_requests, n_workers), device)
    alt_unit = _draws(rng, (n_requests, n_workers), device)
    rel = np.array(
        [math.inf if c.deadline is None else c.deadline for c in classes]
    )
    deadlines = arr_req + rel[cls_idx]
    weights = np.array([c.weight for c in classes], dtype=float)
    return (dist_seq, classes, pol_seq, mw_seq, shed_seq, warm, arr_req,
            names, cls_idx, unit, alt_unit, deadlines, weights)


def _serving_formation(
    dist, n_batches, n_workers, batch_size, max_wait, shed, arr_req,
    cls_idx, names, weights, deadlines, job_load, cache,
):
    """Formation for one (dist, B, max_wait, shed) cell, memoized: 'cap'
    sheds throttle against the cell's drain rate (so formation depends on
    (dist, B)); other kinds share one formation per (max_wait, shed)."""
    if shed.kind == "cap":
        r = n_workers // n_batches
        drain = shed.utilization * n_batches / _mean_min_service(
            dist, r, job_load
        )
        q_max = _THROTTLE_DEPTH * n_batches
        key = (max_wait, shed, drain, q_max)
    else:
        drain, q_max = None, math.inf
        key = (max_wait, shed)
    if key not in cache:
        with _stage("formation"):
            cache[key] = _form_schedule(
                arr_req, cls_idx, names, weights, batch_size, max_wait, shed,
                deadlines, drain, q_max,
            )
    return cache[key]


def _serving_cache_key(seed, n_requests, n_workers, arrivals, class_labels,
                       splits, n_jobs):
    """Group-minima cache key of one serving dispatch.  The minima of rows
    ``[:n_jobs]`` depend on ``n_jobs``, and the draws on whether the
    arrivals and the class labels were given (each one given consumes no
    randomness), so the key holds all three."""
    return ("serving", seed, n_requests, n_workers, arrivals is not None,
            class_labels is not None, tuple(splits), n_jobs,
            _wb_cache_tag(None))


def sweep_sojourn_serving(
    dists: ServiceDistribution | Sequence[ServiceDistribution],
    n_workers: int,
    request_rate: float,
    batch_size: int,
    slo_classes: Sequence[SloClass],
    policies: Sequence[PolicyCandidate],
    max_waits: Sequence[float] = (math.inf,),
    sheds: Sequence[ShedPolicy] = (ShedPolicy("none"),),
    n_requests: int = 20_000,
    seed: int = 0,
    feasible_b: Sequence[int] | None = None,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    class_labels: Sequence[str] | None = None,
    device=None,
) -> ServingSweepResult:
    """Request-level latencies for ALL (B, policy, max_wait, shed) serving
    cells x distributions, under multi-tenant SLO classes.

    One shared request trace (Poisson at ``request_rate``, or
    ``arrivals``/``class_labels`` for trace replay) goes through the WFQ
    formation pre-pass once per (max_wait, shed) combo
    (:func:`_form_schedule`, on the host), and each combo's job stream is
    scanned by the ``sojourn_cells`` kernel on ``device`` through the same
    seam as :func:`sweep_sojourn_policies`, slicing rows ``[:J]`` of one
    shared primary + alternate draw matrix (common random numbers across
    every axis).  Each job carries the FULL ``job_load`` (padded-batch
    assumption: a partially-filled batch costs as much as a full one).

    One launch per combo covers every (dist, B, policy) cell; under 'cap'
    the throttled formation depends on (dist, B), so each (dist, B) has a
    launch of its own.  Every cell is bit-equal to
    :func:`simulate_sojourn_serving` at the same seed and knobs, and to the
    reference's ``pallas`` lane.
    """
    dev = resolve_device(device)
    splits, _ = _resolve_splits(n_workers, feasible_b)
    (dist_seq, classes, pol_seq, mw_seq, shed_seq, warm, arr_req, names,
     cls_idx, unit, alt_unit, deadlines, weights) = _serving_common(
        dists, n_workers, request_rate, batch_size, slo_classes, policies,
        max_waits, sheds, n_requests, seed, job_load, warmup, arrivals,
        class_labels, dev,
    )
    n_d, n_s, n_p = len(dist_seq), len(splits), len(pol_seq)
    n_w, n_h = len(mw_seq), len(shed_seq)
    req_job = np.full((n_d, n_s, n_w, n_h, n_requests), -1, dtype=np.int64)
    formed_out = [[[[None] * n_h for _ in range(n_w)] for _ in range(n_s)]
                  for _ in range(n_d)]
    samples_out = [[[[None] * n_h for _ in range(n_w)] for _ in range(n_s)]
                   for _ in range(n_d)]
    extra = np.zeros((n_d, n_s, n_p, n_w, n_h))
    form_cache: dict = {}

    for wi, mw in enumerate(mw_seq):
        for hi, shed in enumerate(shed_seq):
            if shed.kind == "cap":
                groups = [((di,), (si,))
                          for di in range(n_d) for si in range(n_s)]
            else:
                groups = [(tuple(range(n_d)), tuple(range(n_s)))]
            for dis, sis in groups:
                formed, rj = _serving_formation(
                    dist_seq[dis[0]], splits[sis[0]], n_workers, batch_size,
                    mw, shed, arr_req, cls_idx, names, weights, deadlines,
                    job_load, form_cache,
                )
                n_jobs = len(formed)
                g_splits = [splits[si] for si in sis]
                if n_jobs == 0:
                    smp = np.empty((len(dis), len(sis), n_p, 0))
                    xtr = np.zeros((len(dis), len(sis), n_p))
                else:
                    smp, xtr = _sweep_policies_accel(
                        tuple(dist_seq[di] for di in dis), g_splits, pol_seq,
                        formed, unit[:n_jobs], alt_unit[:n_jobs], None,
                        job_load, n_workers, 0, None,
                        _serving_cache_key(seed, n_requests, n_workers,
                                           arrivals, class_labels, g_splits,
                                           n_jobs),
                    )
                for gi, di in enumerate(dis):
                    for gj, si in enumerate(sis):
                        req_job[di, si, wi, hi] = rj
                        formed_out[di][si][wi][hi] = formed
                        samples_out[di][si][wi][hi] = smp[gi, gj]
                        extra[di, si, :, wi, hi] = xtr[gi, gj]

    return ServingSweepResult(
        n_workers=n_workers,
        batch_size=batch_size,
        splits=tuple(splits),
        policies=pol_seq,
        max_waits=mw_seq,
        sheds=shed_seq,
        dists=dist_seq,
        classes=classes,
        request_arrivals=arr_req,
        request_class=cls_idx,
        deadlines=deadlines,
        warmup=warm,
        formed=tuple(tuple(tuple(tuple(w) for w in s) for s in d)
                     for d in formed_out),
        req_job=req_job,
        samples=tuple(tuple(tuple(tuple(w) for w in s) for s in d)
                      for d in samples_out),
        extra_fraction=extra,
        backend=device_name(dev),
    )


@dataclasses.dataclass(frozen=True)
class ServingSimResult:
    """Standalone replay of ONE serving cell (see
    :func:`simulate_sojourn_serving`)."""

    latency: np.ndarray  # (R,) request latency, NaN = shed
    shed: np.ndarray  # (R,) bool
    request_class: np.ndarray  # (R,) class index
    formed: np.ndarray  # (J,) job formation times
    req_job: np.ndarray  # (R,) job index, -1 = shed
    job_sojourns: np.ndarray  # (J,)
    extra_fraction: float
    warmup: int


def simulate_sojourn_serving(
    dist: ServiceDistribution,
    n_workers: int,
    n_batches: int,
    request_rate: float,
    batch_size: int,
    slo_classes: Sequence[SloClass],
    policy: PolicyCandidate,
    max_wait: float = math.inf,
    shed: ShedPolicy = ShedPolicy("none"),
    n_requests: int = 20_000,
    seed: int = 0,
    job_load: float = 1.0,
    warmup: int | None = None,
    arrivals: Sequence[float] | None = None,
    class_labels: Sequence[str] | None = None,
    device=None,
) -> ServingSimResult:
    """Standalone replay of ONE (B, policy, max_wait, shed) serving cell.

    The companion of :func:`sweep_sojourn_serving`: the same RNG order
    (request arrivals, class labels, primary matrix, alternate matrix — the
    FULL ``(n_requests, n_workers)`` matrices are drawn and the job stream
    slices rows ``[:J]``), the same formation pre-pass, then one
    single-cell ``sojourn_cells`` call of the same seam.  A kernel program
    reads only its own cell, so the latencies are bit-equal to the
    matching sweep cell at the same seed.
    """
    dev = resolve_device(device)
    if n_workers % n_batches:
        raise ValueError(
            f"B={n_batches} infeasible: must divide N={n_workers}"
        )
    (dist_seq, classes, pol_seq, mw_seq, shed_seq, warm, arr_req, names,
     cls_idx, unit, alt_unit, deadlines, weights) = _serving_common(
        dist, n_workers, request_rate, batch_size, slo_classes, (policy,),
        (max_wait,), (shed,), n_requests, seed, job_load, warmup, arrivals,
        class_labels, dev,
    )
    formed, req_job = _serving_formation(
        dist_seq[0], n_batches, n_workers, batch_size, mw_seq[0],
        shed_seq[0], arr_req, cls_idx, names, weights, deadlines, job_load,
        {},
    )
    n_jobs = len(formed)
    if n_jobs:
        smp, xtr = _sweep_policies_accel(
            dist_seq, [n_batches], pol_seq, formed, unit[:n_jobs],
            alt_unit[:n_jobs], None, job_load, n_workers, 0, None,
            _serving_cache_key(seed, n_requests, n_workers, arrivals,
                               class_labels, [n_batches], n_jobs),
        )
        soj, extra_fraction = smp[0, 0, 0], float(xtr[0, 0, 0])
    else:
        soj, extra_fraction = np.empty(0), 0.0
    latency = np.full(n_requests, np.nan)
    served = req_job >= 0
    latency[served] = (
        formed[req_job[served]] - arr_req[served] + soj[req_job[served]]
    )
    return ServingSimResult(
        latency=latency,
        shed=~served,
        request_class=cls_idx,
        formed=formed,
        req_job=req_job,
        job_sojourns=soj,
        extra_fraction=extra_fraction,
        warmup=warm,
    )


# ---------------------------------------------------------------------------
# runtime-facing step-time telemetry (host numpy)
# ---------------------------------------------------------------------------


def _iid_times_from_unit(unit: np.ndarray, loads: np.ndarray,
                         dist: ServiceDistribution,
                         rates: np.ndarray | None) -> np.ndarray:
    """Worker times ``loads_j * unit_time_j`` of one step, on the host.

    Parametric: ``shift + E/(mu*rate)``.  Empirical: an i.i.d. inverse-ECDF
    lookup of each draw's uniform (``1 - exp(-E)``), with a rate scaling
    the whole draw; a rank coupling over one N-vector would repeat the same
    N quantiles every step.
    """
    if isinstance(dist, Empirical):
        core = dist.ppf(-np.expm1(-unit))
        core = core if rates is None else core / rates
    else:
        shift, mu = _dist_params(dist)
        core = shift + unit / (mu if rates is None else mu * rates)
    return core * loads


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """A scheduled fault: worker ``worker`` is dead during steps
    [start_step, end_step)."""

    worker: int
    start_step: int
    end_step: int


class StepTimeSimulator:
    """Per-step, per-worker service times for the tuner and the runtime.

    On top of the base distribution: i.i.d. randomness (the paper's
    model), persistent slow workers (``slow_workers``: a multiplicative
    slowdown), per-worker base rates (``rates``: worker j's exponential
    part runs at ``mu * rates[j]``) and transient faults (``np.inf`` for a
    dead worker).  One ``standard_exponential(N)`` a step from
    ``np.random.default_rng(seed)``, the reference's stream.
    """

    def __init__(
        self,
        dist: ServiceDistribution,
        n_workers: int,
        seed: int = 0,
        slow_workers: dict[int, float] | None = None,
        faults: Sequence[FaultEvent] = (),
        rates: Sequence[float] | None = None,
    ):
        self._dist = dist
        self._n = n_workers
        self._rng = np.random.default_rng(seed)
        self._slow = dict(slow_workers or {})
        for w in self._slow:
            if not 0 <= w < n_workers:
                raise ValueError(f"slow worker id {w} out of range")
        self._rates = _validate_rates(rates, n_workers)
        self._faults = list(faults)
        self.step = 0

    def next_step(self, loads: np.ndarray | None = None) -> np.ndarray:
        """One step of per-worker service times; ``loads`` are the units of
        data per worker (default 1.0 each)."""
        if loads is None:
            loads = np.ones(self._n)
        loads = np.asarray(loads, dtype=float)
        if loads.shape != (self._n,):
            raise ValueError(f"loads shape {loads.shape} != ({self._n},)")
        unit = self._rng.standard_exponential(self._n)
        times = _iid_times_from_unit(unit, loads, self._dist, self._rates)
        for w, factor in self._slow.items():
            times[w] *= factor
        for ev in self._faults:
            if ev.start_step <= self.step < ev.end_step:
                times[ev.worker] = np.inf
        self.step += 1
        return times

    def alive_mask(self) -> np.ndarray:
        mask = np.ones(self._n, dtype=bool)
        for ev in self._faults:
            if ev.start_step <= self.step < ev.end_step:
                mask[ev.worker] = False
        return mask


def censored_observations(
    times: np.ndarray, assignment: Assignment, used: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker (observed_time, censored) telemetry under the paper's rule.

    A batch's first response cancels its other replicas, so an unused
    replica is recorded AT its batch's cancellation time and marked
    censored; a dead worker (inf) too, or stays inf when its whole batch
    died.
    """
    times = np.asarray(times, dtype=float)
    used = np.asarray(used, dtype=bool)
    batch_done = np.full(assignment.n_batches, np.inf)
    for w, b in enumerate(assignment.worker_batch):
        t = times[w]
        if np.isfinite(t) and t < batch_done[b]:
            batch_done[b] = t
    cancel = np.array([batch_done[b] for b in assignment.worker_batch])
    return np.minimum(times, cancel), ~used


def completion_from_step_times(
    times: np.ndarray, assignment: Assignment
) -> tuple[float, np.ndarray]:
    """The paper's completion rule on one step of worker times.

    Returns ``(completion_time, used_mask)``: the fastest replica of each
    batch is used; a batch with no finite replica makes the step's
    completion inf.
    """
    b = assignment.n_batches
    used = np.zeros(assignment.n_workers, dtype=bool)
    batch_done = np.full(b, np.inf)
    for batch in range(b):
        members = [j for j, wb in enumerate(assignment.worker_batch)
                   if wb == batch]
        t = times[members]
        k = int(np.argmin(t))
        if np.isfinite(t[k]):
            batch_done[batch] = t[k]
            used[members[k]] = True
    return float(batch_done.max()), used
