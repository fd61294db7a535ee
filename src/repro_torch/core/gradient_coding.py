"""Cyclic gradient coding (Tandon et al., arXiv:1612.03301).

The port carries only :class:`CyclicGradientCode`: the coded kernels need
its encode coefficients (``kernels/coded/ops.encode_matrix``) and its
decode weights (the decode-weight solve the overhead probe times).  The
Monte-Carlo comparison helpers of ``repro.core.gradient_coding`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CyclicGradientCode"]


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
