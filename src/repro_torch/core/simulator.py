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
cell build, scan); a caller zeroes it with :func:`reset_stage_seconds`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels import sojourn_sweep as _ss
from .coding import CodingCandidate
from .order_stats import Empirical, ServiceDistribution
from .policies import PolicyCandidate, _validate_rates, divisors

__all__ = [
    "SimResult",
    "SweepSimResult",
    "SpeculativeSweepResult",
    "PolicySweepResult",
    "CodedSweepResult",
    "sweep_simulate",
    "sweep_coded",
    "sweep_sojourn",
    "sweep_sojourn_speculative",
    "sweep_sojourn_policies",
    "sweep_sojourn_coded",
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
    for q in q_seq:
        if q is not None and not 0.0 < q < 1.0:
            raise ValueError(f"speculation quantile must be in (0, 1), got {q}")
    _validate_load(arrival_rate, job_load)
    rates_arr = _validate_rates(rates, n_workers)
    warm = _resolve_warmup(n_jobs, warmup)
    dev = resolve_device(device)
    arrivals_given = arrivals is not None

    rng = np.random.default_rng(seed)
    arrivals = _resolve_arrivals(arrivals, n_jobs, arrival_rate, rng)
    unit = _draws(rng, (n_jobs, n_workers), dev)
    clone_unit = _draws(rng, (n_jobs, n_workers), dev)
    pol_seq = tuple(
        PolicyCandidate("none") if q is None else PolicyCandidate("clone", q)
        for q in q_seq
    )
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
