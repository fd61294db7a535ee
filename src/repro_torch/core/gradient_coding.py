"""Cyclic gradient coding (Tandon et al., arXiv:1612.03301) beside the
paper's replication.

Replication, overhead r = N/B, waits for the fastest replica of EVERY
batch (``T = max_b min_j T_bj``); cyclic gradient coding, overhead s+1,
decodes from ANY N-s workers (``T`` = the (N-s)-th order statistic of the
N worker times, each worker loaded with s+1 units).

* :class:`CyclicGradientCode` — the encode coefficients and decode weights
  (the coded kernels' ``encode_matrix`` and the overhead probe use them).
* :func:`simulate_gradient_coding` — the k-of-N completion on the
  ``coded_cells`` kernel (float32), one cell.
* :func:`expected_coding_time` — its closed form for Exp/SExp.
* :func:`compare_schemes` — E[T] of both schemes at every overhead from
  one shared draw matrix, float64 on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import sojourn_sweep as _ss
from .order_stats import (
    Exponential,
    ServiceDistribution,
    ShiftedExponential,
    harmonic,
)
from .policies import divisors
from .simulator import SimResult, _draws, _shared_draw_order, _unit_times

__all__ = [
    "CyclicGradientCode",
    "simulate_gradient_coding",
    "expected_coding_time",
    "compare_schemes",
]


@dataclasses.dataclass(frozen=True)
class CyclicGradientCode:
    """Cyclic code: worker i computes batches {i..i+s} mod N and sends the
    COEFFICIENT-weighted sum (Tandon's construction needs generic — here
    seeded-Gaussian — coefficients on the cyclic support: plain 0/1 partial
    sums are NOT decodable from every (N-s)-subset)."""

    n_workers: int
    s: int  # straggler tolerance; storage overhead = s+1
    seed: int = 0

    def __post_init__(self):
        if not 0 <= self.s < self.n_workers:
            raise ValueError(f"s must be in [0, N), got {self.s}")

    @property
    def overhead(self) -> int:
        return self.s + 1

    def assignment(self) -> np.ndarray:
        """(N, N) bool: worker i holds batch j."""
        n, s = self.n_workers, self.s
        mat = np.zeros((n, n), dtype=bool)
        for i in range(n):
            for k in range(s + 1):
                mat[i, (i + k) % n] = True
        return mat

    def coefficients(self) -> np.ndarray:
        """(N, N) encode matrix B via Tandon et al. Algorithm 1: rows have
        cyclic support {i..i+s} and satisfy B Hᵀ = 0 for a random H whose
        rows sum to zero — which guarantees ANY N-s rows span 1ᵀ (their
        Lemma 2).  Worker i transmits  B[i] · (g_1..g_N)."""
        n, s = self.n_workers, self.s
        if s == 0:
            return np.eye(n)
        rng = np.random.default_rng(self.seed)
        h = rng.standard_normal((s, n))
        h[:, -1] = -h[:, :-1].sum(axis=1)  # rows of H sum to zero
        b = np.zeros((n, n))
        for i in range(n):
            idx = (np.arange(s + 1) + i) % n
            b[i, idx[0]] = 1.0
            b[i, idx[1:]] = -np.linalg.solve(h[:, idx[1:]], h[:, idx[0]])
        return b

    def decode_weights(self, alive: np.ndarray) -> np.ndarray | None:
        """Weights over ALIVE workers reconstructing the uniform batch sum
        (1^T g), or None if undecodable.  Solves B_alive^T w = 1; exact for
        any >= N-s alive workers (Tandon Thm 1, generic coefficients)."""
        alive = np.asarray(alive, dtype=bool)
        if alive.sum() < self.n_workers - self.s:
            return None
        b = self.coefficients()[alive]  # (m, N)
        w, *_ = np.linalg.lstsq(b.T, np.ones(self.n_workers), rcond=None)
        if not np.allclose(b.T @ w, 1.0, atol=1e-6):
            return None
        return w


def simulate_gradient_coding(
    dist: ServiceDistribution,
    n_workers: int,
    s: int,
    n_trials: int = 20_000,
    seed: int = 0,
    device=None,
) -> SimResult:
    """Completion = the (N-s)-th smallest of the N worker times, each
    worker loaded with s+1 units.

    One ``coded_cells`` cell on the shared draw matrix: the float64 times
    ``unit_time * (s+1)`` cast to float32, then the k-th order statistic
    with k = N - s.  Rounding is monotone, so each sample is the float32
    rounding of the reference's float64 sample, and equals the cyclic cell
    of the reference's ``sweep_coded`` float32 lanes at the same seed.
    """
    if not 0 <= s < n_workers:
        raise ValueError(f"s must be in [0, N={n_workers}), got {s}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    unit = _draws(rng, (n_trials, n_workers), dev)
    order = _shared_draw_order((dist,), unit)
    cells = (_unit_times(unit, dist, None, order=order)
             * float(s + 1)).to(torch.float32)[None]
    out = _ss.coded_completion_cells(cells, [n_workers - s])
    return SimResult(out[0].to(torch.float64).cpu().numpy())


def expected_coding_time(
    dist: ServiceDistribution, n_workers: int, s: int
) -> float:
    """Closed form for Exp/SExp: E[(N-s)-th order stat of N iid].

    For Exp(mu_w): E[X_(k)] = (H_N - H_{N-k}) / mu_w with k = N-s.
    SExp adds the deterministic shift (s+1)Delta.
    """
    n, k = n_workers, n_workers - s
    scaled = dist.scaled(s + 1)
    if isinstance(scaled, ShiftedExponential):
        return scaled.delta + (harmonic(n) - harmonic(n - k)) / scaled.mu
    if isinstance(scaled, Exponential):
        return (harmonic(n) - harmonic(n - k)) / scaled.mu
    raise TypeError(f"unsupported distribution {dist!r}")


def compare_schemes(
    dist: ServiceDistribution,
    n_workers: int,
    n_trials: int = 20_000,
    seed: int = 0,
    device=None,
) -> dict:
    """E[T] across storage overheads for replication vs gradient coding.

    Replication overheads are N/B for feasible B; coding overheads are s+1
    for s in [0, N).  Returns ``{"replication": {r: E}, "coding": {s+1:
    E}, "common": {overhead: {"replication": E, "coding": E}}}``.  Both
    curves come from ONE (n_trials, N) draw matrix in float64 on
    ``device``.  Sorting commutes with multiplying by a positive constant,
    so one sort of each trial's unit-load times gives every s: the (N-s)-th
    smallest time at load s+1 is ``(s+1) * sorted[:, N-s-1]``, the same
    product the reference forms before its sort.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    unit = _draws(rng, (n_trials, n_workers), dev)
    core = _unit_times(unit, dist, None, order=_shared_draw_order((dist,), unit))

    rep = {}
    for b in divisors(n_workers):
        r = n_workers // b
        times = core * float(r)
        rep[r] = float(
            times.reshape(n_trials, b, r).amin(dim=2).amax(dim=1).mean())
    ranked = torch.sort(core, dim=1).values
    cod = {s + 1: float((ranked[:, n_workers - s - 1] * float(s + 1)).mean())
           for s in range(n_workers)}
    both = {
        oh: {"replication": rep[oh], "coding": cod[oh]}
        for oh in sorted(set(rep) & set(cod))
    }
    return {"replication": rep, "coding": cod, "common": both}
