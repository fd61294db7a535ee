"""Coded-computation candidates: the planner's alternative to replication.

The paper proves balanced replication of disjoint batches is the optimal
*replication* policy, but replication and coding occupy one design space
(Peng/Soljanin/Whiting): at fixed redundancy, diversity (coding) and
parallelism (splitting) trade off and the winner flips with the service
distribution's tail.  This module supplies the coded side of that race:

* :class:`CodingCandidate` — a scheme the sweep can score next to the
  feasible B values: cyclic gradient coding (Tandon et al.; the repo's
  :class:`~repro_torch.core.gradient_coding.CyclicGradientCode`), real-valued
  ``(n, k)`` MDS coverage, or polynomial-coded matmul (Yu/Maleki/
  Avestimehr — the ``avestimehr_matmul.py`` exemplar, real-valued here).
* :class:`MDSCode` / :class:`PolynomialMatmulCode` — the actual encode /
  decode linear algebra, exact from ANY k-of-n completion subset
  (the port's copy of ``repro.core.coding``, held equal to it in
  ``tests/test_torch_core.py``).
* :func:`expected_kofn_time` — the closed-form k-of-n completion mean for
  Exp/SExp.

Under the paper's size-dependent service model all three schemes reduce to
the same completion geometry — per-worker load ``load(n)`` units and the
``k(n)``-th order statistic of the N worker times — which is what lets the
simulator score every ``(scheme, s)`` cell on the shared CRN draw matrix
(:func:`~repro_torch.core.simulator.sweep_coded`).  Encode/decode cost is NOT
assumed free: candidates carry ``encode_overhead`` / ``decode_overhead``
(time units added to every completion sample), and leaving them ``None``
asks the planner to MEASURE them on the sweep's device
(:func:`repro_torch.kernels.coded.measure_coding_overhead`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .order_stats import (
    Exponential,
    ServiceDistribution,
    ShiftedExponential,
    harmonic,
)

__all__ = [
    "CODING_SCHEMES",
    "CodingCandidate",
    "MDSCode",
    "PolynomialMatmulCode",
    "chebyshev_nodes",
    "expected_kofn_time",
]

CODING_SCHEMES = ("cyclic", "mds", "poly")


@dataclasses.dataclass(frozen=True)
class CodingCandidate:
    """One coded scheme the planning sweep scores against replication.

    ``s`` is the straggler tolerance: the job completes once any
    ``k = N - s`` workers respond.  The schemes differ in per-worker load
    (the redundancy they pay for that tolerance):

    * ``cyclic`` — cyclic gradient coding; each worker computes ``s + 1``
      of the N unit batches, so load ``s + 1``.
    * ``mds`` — ``(N, k)`` MDS code over the data; each worker holds ONE
      coded chunk of ``N / k`` units, so load ``N / k``.
    * ``poly`` — polynomial-coded matmul (same coverage geometry as MDS:
      any ``k = mn`` of N products interpolate the degree-``mn - 1``
      polynomial, per-worker load ``N / k``); decode is
      :class:`PolynomialMatmulCode`.

    ``encode_overhead`` / ``decode_overhead`` are time units ADDED to every
    completion sample (encode before dispatch, decode on the k-th
    completion).  ``None`` means "measure at plan time" on the sweep's
    device; the resolved values land on :attr:`~repro_torch.core.planner.
    Plan.coding`.  Tests pass explicit values for determinism.
    """

    scheme: str = "cyclic"
    s: int = 0
    encode_overhead: Optional[float] = None
    decode_overhead: Optional[float] = None

    def __post_init__(self):
        if self.scheme not in CODING_SCHEMES:
            raise ValueError(
                f"unknown coding scheme {self.scheme!r} "
                f"(expected one of {CODING_SCHEMES})"
            )
        if not isinstance(self.s, (int, np.integer)) or self.s < 0:
            raise ValueError(
                f"straggler tolerance s must be a non-negative int, "
                f"got {self.s!r}"
            )
        for name in ("encode_overhead", "decode_overhead"):
            v = getattr(self, name)
            if v is not None:
                v = float(v)
                if not (np.isfinite(v) and v >= 0.0):
                    raise ValueError(
                        f"{name} must be finite and >= 0, got {v}"
                    )
                object.__setattr__(self, name, v)

    def k(self, n_workers: int) -> int:
        """Completions needed: the job finishes at the k-th order statistic."""
        if self.s >= n_workers:
            raise ValueError(
                f"s={self.s} tolerates every worker: need s < N={n_workers}"
            )
        return n_workers - self.s

    def load(self, n_workers: int) -> float:
        """Per-worker data units when the full job is ``n_workers`` units."""
        k = self.k(n_workers)
        if self.scheme == "cyclic":
            return float(self.s + 1)
        return n_workers / k

    @property
    def resolved(self) -> bool:
        """True once both overheads carry measured/explicit values."""
        return self.encode_overhead is not None and \
            self.decode_overhead is not None

    @property
    def total_overhead(self) -> float:
        """Encode + decode time added to every completion (None -> 0)."""
        return (self.encode_overhead or 0.0) + (self.decode_overhead or 0.0)

    def describe(self) -> str:
        return f"{self.scheme}(s={self.s})"


def chebyshev_nodes(n: int) -> np.ndarray:
    """``n`` distinct evaluation points in (-1, 1).

    Chebyshev nodes keep the real-valued Vandermonde systems of
    :class:`MDSCode` / :class:`PolynomialMatmulCode` far better conditioned
    than equispaced points (the finite-field exemplar uses powers of a
    primitive root; over the reals node placement is the analogous degree
    of freedom).
    """
    if n < 1:
        raise ValueError(f"need n >= 1 nodes, got {n}")
    return np.cos(np.pi * (2.0 * np.arange(n) + 1.0) / (2.0 * n))


@dataclasses.dataclass(frozen=True)
class MDSCode:
    """Real-valued ``(n, k)`` MDS code: any k coded rows recover the data.

    The generator is the Vandermonde matrix ``G[i, j] = x_i**j`` at
    distinct :func:`chebyshev_nodes` — every k-row submatrix is itself a
    Vandermonde at distinct points, hence invertible, which IS the MDS
    property.  ``encode`` maps k data blocks to n coded blocks; ``decode``
    recovers the data exactly from any >= k completions.
    """

    n: int
    k: int

    def __post_init__(self):
        if not 1 <= self.k <= self.n:
            raise ValueError(f"need 1 <= k <= n, got (n={self.n}, k={self.k})")

    def generator(self) -> np.ndarray:
        """(n, k) encode matrix."""
        x = chebyshev_nodes(self.n)
        return np.vander(x, self.k, increasing=True)

    def encode(self, blocks: np.ndarray) -> np.ndarray:
        """(k, ...) data blocks -> (n, ...) coded blocks."""
        blocks = np.asarray(blocks)
        if blocks.shape[0] != self.k:
            raise ValueError(
                f"expected {self.k} data blocks, got {blocks.shape[0]}"
            )
        return np.tensordot(self.generator(), blocks, axes=(1, 0))

    def decode_weights(self, alive: np.ndarray) -> np.ndarray | None:
        """(k, m) matrix W with ``W @ coded[alive] == blocks`` exactly, or
        None when fewer than k workers are alive."""
        alive = np.asarray(alive, dtype=bool)
        m = int(alive.sum())
        if m < self.k:
            return None
        g = self.generator()[alive]  # (m, k)
        if m == self.k:
            return np.linalg.inv(g)
        return np.linalg.pinv(g)

    def decode(self, coded: np.ndarray, alive: np.ndarray) -> np.ndarray:
        """Recover the (k, ...) data blocks from the alive coded blocks.

        ``coded`` holds the alive workers' blocks (in worker order).
        """
        w = self.decode_weights(alive)
        if w is None:
            raise ValueError(
                f"undecodable: {int(np.asarray(alive).sum())} alive < k={self.k}"
            )
        return np.tensordot(w, np.asarray(coded), axes=(1, 0))


@dataclasses.dataclass(frozen=True)
class PolynomialMatmulCode:
    """Polynomial-coded matmul ``A @ B.T`` (Yu/Maleki/Avestimehr).

    ``A`` is split into ``m`` row-blocks, ``B`` into ``p`` row-blocks.
    Worker ``i`` receives the polynomial evaluations

    ``Aenc_i = sum_j A_j x_i**j``,  ``Benc_i = sum_l B_l x_i**(l*m)``

    and returns ``Aenc_i @ Benc_i.T`` — the value at ``x_i`` of a matrix
    polynomial of degree ``m*p - 1`` whose coefficients are exactly the
    ``m*p`` products ``A_j @ B_l.T``.  ANY ``k = m*p`` completions
    therefore interpolate the full product (the exemplar works in
    GF(65537); here the nodes are real :func:`chebyshev_nodes` and decode
    is a Vandermonde solve).
    """

    m: int
    p: int
    n_workers: int

    def __post_init__(self):
        if self.m < 1 or self.p < 1:
            raise ValueError(
                f"need m, p >= 1, got (m={self.m}, p={self.p})"
            )
        if self.n_workers < self.m * self.p:
            raise ValueError(
                f"need n_workers >= m*p={self.m * self.p} for decodability, "
                f"got {self.n_workers}"
            )

    @property
    def k(self) -> int:
        return self.m * self.p

    def _nodes(self) -> np.ndarray:
        return chebyshev_nodes(self.n_workers)

    def _vandermonde(self) -> np.ndarray:
        """(n_workers, k) evaluation matrix at exponents ``j + l*m``."""
        x = self._nodes()
        return np.vander(x, self.k, increasing=True)

    def _split(self, mat: np.ndarray, parts: int, what: str) -> np.ndarray:
        mat = np.asarray(mat, dtype=float)
        if mat.ndim != 2 or mat.shape[0] % parts:
            raise ValueError(
                f"{what} must be 2-D with row count divisible by {parts}, "
                f"got shape {mat.shape}"
            )
        return mat.reshape(parts, mat.shape[0] // parts, mat.shape[1])

    def encode_a(self, a: np.ndarray) -> np.ndarray:
        """(rows_a, d) -> (n_workers, rows_a/m, d) encoded A shards."""
        blocks = self._split(a, self.m, "A")
        x = self._nodes()
        powers = np.vander(x, self.m, increasing=True)  # x_i**j
        return np.tensordot(powers, blocks, axes=(1, 0))

    def encode_b(self, b: np.ndarray) -> np.ndarray:
        """(rows_b, d) -> (n_workers, rows_b/p, d) encoded B shards."""
        blocks = self._split(b, self.p, "B")
        x = self._nodes()
        powers = np.power.outer(x, self.m * np.arange(self.p))  # x_i**(l*m)
        return np.tensordot(powers, blocks, axes=(1, 0))

    def worker_product(self, a_shard: np.ndarray, b_shard: np.ndarray
                       ) -> np.ndarray:
        """What worker i computes: its coded partial product."""
        return np.asarray(a_shard) @ np.asarray(b_shard).T

    def decode(self, products: np.ndarray, alive: np.ndarray) -> np.ndarray:
        """Full ``A @ B.T`` from any >= k worker products.

        ``products`` holds the alive workers' ``worker_product`` outputs
        (in worker order), shape (m_alive, rows_a/m, rows_b/p).
        """
        alive = np.asarray(alive, dtype=bool)
        m_alive = int(alive.sum())
        if m_alive < self.k:
            raise ValueError(
                f"undecodable: {m_alive} alive < k={self.k}"
            )
        v = self._vandermonde()[alive]  # (m_alive, k)
        prods = np.asarray(products, dtype=float)
        flat = prods.reshape(m_alive, -1)
        coeffs, *_ = np.linalg.lstsq(v, flat, rcond=None)
        ra, rb = prods.shape[1], prods.shape[2]
        blocks = coeffs.reshape(self.p, self.m, ra, rb)  # [l, j] = A_j B_l^T
        # assemble: C[j*ra:(j+1)*ra, l*rb:(l+1)*rb] = A_j @ B_l.T
        out = np.empty((self.m * ra, self.p * rb))
        for j in range(self.m):
            for l in range(self.p):
                out[j * ra:(j + 1) * ra, l * rb:(l + 1) * rb] = blocks[l, j]
        return out


def expected_kofn_time(
    dist: ServiceDistribution, n_workers: int, k: int, load: float = 1.0
) -> float:
    """Closed-form mean of the k-th order statistic of N iid workers at
    per-worker ``load`` units (Exp/SExp only).

    ``E[X_(k)] = load*Delta + load*(H_N - H_{N-k}) / mu`` — the coded twin
    of :func:`~repro_torch.core.order_stats.completion_mean`; the cyclic
    special case is ``k = N - s``, ``load = s + 1``.
    """
    if not 1 <= k <= n_workers:
        raise ValueError(f"need 1 <= k <= N, got (k={k}, N={n_workers})")
    if load <= 0:
        raise ValueError(f"load must be positive, got {load}")
    scaled = dist.scaled(load)
    spread = harmonic(n_workers) - harmonic(n_workers - k)
    if isinstance(scaled, ShiftedExponential):
        return scaled.delta + spread / scaled.mu
    if isinstance(scaled, Exponential):
        return spread / scaled.mu
    raise TypeError(
        f"no closed form for {type(dist).__name__}; use "
        "repro_torch.core.simulator.sweep_coded (the simulator scores any "
        "engine dist)"
    )
