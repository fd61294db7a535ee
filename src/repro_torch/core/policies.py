"""Batching + assignment policies (the paper's Fig. 1 'batching unit' and
'batch assignment unit').

A policy produces an :class:`Assignment`:

* ``batches``      — list of B frozensets of data-unit ids (0..N-1 data units,
                     dataset normalized to N units as in the paper);
* ``worker_batch`` — length-N tuple: which batch each worker serves.

Completion semantics (used by core.simulator): the job is done at the first
time the union of finished workers' batches covers all N data units.  For
non-overlapping policies this reduces to the paper's ``max_i min_j T_ij``.

Heterogeneous fleets: :func:`rate_aware_assignment` places workers by their
relative service rates (balancing each batch's AGGREGATE rate, the quantity
that governs E[T] under exponential service) instead of replica counts.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Assignment",
    "PolicyCandidate",
    "ShedPolicy",
    "SloClass",
    "balanced_nonoverlapping",
    "replica_major_nonoverlapping",
    "unbalanced_nonoverlapping",
    "overlapping_cyclic",
    "random_assignment",
    "rate_aware_assignment",
    "divisors",
]


def _pair_means(dist) -> tuple[float | None, float | None]:
    """(E[X], E[min(X1, X2)]) of a service distribution, or (None, None).

    Exp/SExp-shaped distributions (exposing ``mu`` + optional ``delta``)
    get the closed form ``shift + 1/(k*mu)``; anything with a quantile
    function gets the identity ``E[min2] = int_0^1 ppf(v) * 2(1-v) dv`` on
    a midpoint grid.  Used by :meth:`PolicyCandidate.work_factor`.
    """
    if dist is None:
        return None, None
    mu = getattr(dist, "mu", None)
    if mu is not None:
        shift = float(getattr(dist, "delta", 0.0))
        return shift + 1.0 / float(mu), shift + 0.5 / float(mu)
    ppf = getattr(dist, "ppf", None)
    if ppf is None:
        return None, None
    levels = (2.0 * np.arange(512) + 1.0) / 1024.0
    vals = np.asarray(ppf(levels), dtype=float)
    return float(vals.mean()), float((vals * 2.0 * (1.0 - levels)).mean())


@dataclasses.dataclass(frozen=True)
class PolicyCandidate:
    """One straggler-mitigation policy setting for the planner to score.

    The planner's policy axis (Behrouzi-Far & Soljanin 2020: replicate-
    from-start vs relaunch win in different service regimes; Aktaş et al.:
    the clone trigger matters as much as the redundancy level).  Kinds:

    * ``'none'``     — dispatch once, wait (the baseline every sweep keeps);
    * ``'clone'``    — speculative re-dispatch: a job late past the
      ``quantile`` of its set-service distribution grabs an idle set for a
      clone, first-response-wins;
    * ``'relaunch'`` — cancel the late attempt and re-draw fresh on the
      SAME set (no extra capacity; pays off only when service has memory);
    * ``'hedged'``   — dispatch to TWO replica-sets up front for a
      ``hedge_fraction`` of jobs (deterministic stride), racing from t=0.

    ``quantile`` is the late-trigger for clone/relaunch (``None`` = the
    trigger never fires, i.e. the disabled setting); ``hedge_fraction`` is
    meaningful only for ``'hedged'`` (0.0 disables hedging entirely).
    """

    kind: str = "none"  # 'none' | 'clone' | 'relaunch' | 'hedged'
    quantile: float | None = None  # late trigger (clone/relaunch only)
    hedge_fraction: float = 1.0  # fraction of jobs hedged ('hedged' only)

    def __post_init__(self):
        if self.kind not in ("none", "clone", "relaunch", "hedged"):
            raise ValueError(
                f"unknown policy kind {self.kind!r} "
                "(use 'none'|'clone'|'relaunch'|'hedged')"
            )
        if self.quantile is not None:
            if self.kind not in ("clone", "relaunch"):
                raise ValueError(
                    f"{self.kind!r} policy takes no trigger quantile"
                )
            if not 0.0 < self.quantile < 1.0:
                raise ValueError(
                    f"trigger quantile must be in (0, 1), got {self.quantile}"
                )
        if not 0.0 <= self.hedge_fraction <= 1.0:
            raise ValueError(
                f"hedge_fraction must be in [0, 1], got {self.hedge_fraction}"
            )
        if self.kind != "hedged" and self.hedge_fraction != 1.0:
            raise ValueError(
                f"hedge_fraction only applies to 'hedged', not {self.kind!r}"
            )

    @property
    def enabled(self) -> bool:
        """False when the setting can never fire (the baseline cells)."""
        if self.kind == "none":
            return False
        if self.kind in ("clone", "relaunch"):
            return self.quantile is not None
        return self.hedge_fraction > 0.0

    def work_factor(self, dist=None) -> float:
        """Expected service WORK per job relative to an unmitigated job.

        The redundancy charge load-aware capacity accounting applies
        (Aktaş/Soljanin: clones attack capacity as well as stragglers):

        * ``'none'`` / ``'relaunch'`` — 1.0 (relaunch re-draws on the SAME
          set, no extra capacity);
        * ``'clone'``  — ``1 + (1 - quantile)``: the trigger fires for the
          ``(1-q)`` late fraction and the clone occupies at most one extra
          set for at most its own service (an upper bound — clones launch
          idle-only, so the true charge is no larger);
        * ``'hedged'`` — ``1 + f * (2 E[min(X1,X2)] / E[X] - 1)`` with the
          pair mean from ``dist`` (both racing sets run until the winner
          cancels them).  Memoryless service makes hedging work-NEUTRAL
          (the factor collapses to 1); a shift-dominated fleet pays nearly
          the full duplicate.  Without a usable ``dist`` the conservative
          full-duplicate bound ``1 + f`` applies.
        """
        if not self.enabled or self.kind == "relaunch":
            return 1.0
        if self.kind == "clone":
            return 2.0 - self.quantile
        mean, mean_min2 = _pair_means(dist)
        if mean is None or mean <= 0:
            return 1.0 + self.hedge_fraction
        extra = max(2.0 * mean_min2 / mean - 1.0, 0.0)
        return 1.0 + self.hedge_fraction * extra


@dataclasses.dataclass(frozen=True)
class SloClass:
    """One tenant class of a multi-tenant serving objective.

    * ``name``        — the request ``slo`` label
      this class matches;
    * ``share``       — this class's fraction of request traffic (shares
      are normalized across the objective's classes);
    * ``weight``      — fair-share weight: drives both the master's WFQ
      batch formation and the weight of this class's metric in the sweep's
      scoring;
    * ``deadline``    — relative SLO deadline per request (sim-time units;
      ``None`` = no deadline, the throughput-tenant setting);
    * ``miss_target`` — maximum acceptable miss fraction (shed requests
      count as misses).  Cells breaching any class's target are infeasible
      in the sweep; requires a ``deadline``.

    >>> SloClass("premium", share=0.25, weight=4.0, deadline=2.0,
    ...          miss_target=0.05)
    SloClass(name='premium', share=0.25, weight=4.0, deadline=2.0, miss_target=0.05)
    """

    name: str
    share: float = 1.0
    weight: float = 1.0
    deadline: float | None = None
    miss_target: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant class needs a non-empty name")
        if self.share <= 0 or not np.isfinite(self.share):
            raise ValueError(f"share must be positive finite, got {self.share}")
        if self.weight <= 0 or not np.isfinite(self.weight):
            raise ValueError(
                f"weight must be positive finite, got {self.weight}"
            )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"deadline must be positive, got {self.deadline}"
            )
        if self.miss_target is not None:
            if self.deadline is None:
                raise ValueError(
                    f"class {self.name!r}: miss_target needs a deadline"
                )
            if not 0.0 <= self.miss_target < 1.0:
                raise ValueError(
                    f"miss_target must be in [0, 1), got {self.miss_target}"
                )


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """One admission-control / load-shedding setting for the sweep to score.

    * ``'none'``    — serve everything (the baseline every sweep keeps);
    * ``'expired'`` — drop requests already past their deadline at
      admission or formation (``QueuePolicy.drop_expired``);
    * ``'cap'``     — full admission control: batch formation is throttled
      to a ``utilization`` fraction of the fleet's modeled drain rate, so
      overload backlog accumulates in the admission queue, where arrivals
      finding ``cap`` requests queued are shed — weight-aware under WFQ
      (``QueuePolicy.queue_cap``): a heavier-class arrival evicts the
      newest request of the cheapest backlogged class instead of being
      shed itself, so overload lands on the low-weight tenants first.

    >>> ShedPolicy("cap", cap=32)
    ShedPolicy(kind='cap', cap=32, utilization=0.9)
    """

    kind: str = "none"  # 'none' | 'expired' | 'cap'
    cap: int | None = None  # queue-length cap ('cap' only)
    utilization: float = 0.9  # admission throttle target ('cap' only)

    def __post_init__(self):
        if self.kind not in ("none", "expired", "cap"):
            raise ValueError(
                f"unknown shed kind {self.kind!r} "
                "(use 'none'|'expired'|'cap')"
            )
        if (self.cap is not None) != (self.kind == "cap"):
            raise ValueError(
                f"cap is required for 'cap' and only 'cap', got {self!r}"
            )
        if self.cap is not None and self.cap < 1:
            raise ValueError(f"cap must be >= 1, got {self.cap}")
        if not 0.0 < self.utilization <= 1.0:
            raise ValueError(
                f"utilization must be in (0, 1], got {self.utilization}"
            )


def divisors(n: int) -> list[int]:
    """All positive divisors of n, ascending (feasible B values, B | N)."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return small + large[::-1]


@dataclasses.dataclass(frozen=True)
class Assignment:
    """A concrete placement of data batches onto workers."""

    n_workers: int
    n_units: int
    batches: tuple[frozenset, ...]
    worker_batch: tuple[int, ...]  # worker j serves batches[worker_batch[j]]

    def __post_init__(self):
        if len(self.worker_batch) != self.n_workers:
            raise ValueError("one batch index per worker required")
        covered = set().union(*self.batches) if self.batches else set()
        if covered != set(range(self.n_units)):
            raise ValueError("batches must cover all data units")
        used = set(self.worker_batch)
        if used != set(range(len(self.batches))):
            raise ValueError("every batch must be assigned to >=1 worker")

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    @property
    def batch_sizes(self) -> tuple[int, ...]:
        return tuple(len(b) for b in self.batches)

    @property
    def replication(self) -> tuple[int, ...]:
        """Number of workers serving each batch."""
        counts = [0] * self.n_batches
        for b in self.worker_batch:
            counts[b] += 1
        return tuple(counts)

    @property
    def is_overlapping(self) -> bool:
        total = sum(self.batch_sizes)
        return total > self.n_units

    def coverage_matrix(self) -> np.ndarray:
        """(n_workers, n_units) bool: worker j covers unit u."""
        mat = np.zeros((self.n_workers, self.n_units), dtype=bool)
        for j, b in enumerate(self.worker_batch):
            mat[j, list(self.batches[b])] = True
        return mat

    def worker_load(self) -> np.ndarray:
        """Units of data each worker processes (drives service-time scaling)."""
        return np.array([len(self.batches[b]) for b in self.worker_batch], float)


def _validate_rates(rates, n: int):
    """Validate an optional per-worker rate vector: shape (n,), positive,
    finite.  None passes through (homogeneous).  Shared by the assignment
    policies and the simulator's sampling paths."""
    if rates is None:
        return None
    r = np.asarray(rates, dtype=float)
    if r.shape != (n,):
        raise ValueError(f"rates shape {r.shape} != ({n},)")
    if np.any(r <= 0) or np.any(~np.isfinite(r)):
        raise ValueError("rates must be positive and finite")
    return r


def _equal_batches(n_workers: int, n_batches: int) -> tuple[frozenset, ...]:
    """B disjoint contiguous batches of N/B data units each (B must divide N)."""
    if n_workers % n_batches:
        raise ValueError(f"B={n_batches} must divide N={n_workers}")
    size = n_workers // n_batches
    return tuple(
        frozenset(range(i * size, (i + 1) * size)) for i in range(n_batches)
    )


def balanced_nonoverlapping(n_workers: int, n_batches: int) -> Assignment:
    """The paper's optimal policy (Thm 1): B disjoint equal batches, each
    replicated on exactly N/B workers."""
    batches = _equal_batches(n_workers, n_batches)
    size = n_workers // n_batches
    worker_batch = tuple(j // size for j in range(n_workers))
    return Assignment(n_workers, n_workers, batches, worker_batch)


def replica_major_nonoverlapping(n_workers: int, n_batches: int) -> Assignment:
    """Thm 1's balanced policy in the RUNTIME's coordinate layout.

    Same batches and replication counts as :func:`balanced_nonoverlapping`,
    but worker j serves batch ``j % B`` — the replica-major enumeration of the
    (replica, batch) grid used by ``make_rdp_mesh`` /
    ``batch_index_for_data_coord`` (replicas outermost, so replicas of one
    batch land in different pods).  This is the layout the training/serving
    control planes hand out, keeping the completion rule, the data feed, and
    the gradient aggregation on ONE worker->batch map.
    """
    batches = _equal_batches(n_workers, n_batches)
    worker_batch = tuple(j % n_batches for j in range(n_workers))
    return Assignment(n_workers, n_workers, batches, worker_batch)


def unbalanced_nonoverlapping(
    n_workers: int, replication: Sequence[int]
) -> Assignment:
    """Disjoint equal-size batches with a custom (unbalanced) replication
    vector; sum(replication) == N.  Used to verify Thm 1 numerically."""
    reps = list(replication)
    if sum(reps) != n_workers:
        raise ValueError(f"replication {reps} must sum to N={n_workers}")
    if any(r <= 0 for r in reps):
        raise ValueError(f"replication counts must be positive: {reps}")
    b = len(reps)
    batches = _equal_batches(n_workers, b)
    worker_batch = []
    for i, r in enumerate(reps):
        worker_batch.extend([i] * r)
    return Assignment(n_workers, n_workers, batches, tuple(worker_batch))


def overlapping_cyclic(n_workers: int, n_batches: int) -> Assignment:
    """Overlapping batches: same batch size N/B as the balanced policy but
    batch i starts at offset i * N/B' with B' = N/(N/B) ... concretely we tile
    N overlapping windows of length N/B with stride N/B_eff < N/B so adjacent
    batches share units.  We build N/B-sized windows at stride N/n_batches
    rounded; each worker serves one window (cyclically).

    This realizes the paper's 'partial overlap' regime; the simulator shows it
    is dominated by the balanced non-overlapping policy (Thm 1 discussion).
    """
    if n_workers % n_batches:
        raise ValueError(f"B={n_batches} must divide N={n_workers}")
    size = n_workers // n_batches  # same batch size as non-overlapping
    if size == n_workers:
        # full diversity is already 'everything everywhere'; no overlap variant
        return balanced_nonoverlapping(n_workers, 1)
    n_units = n_workers
    # one window per worker, stride 1*size//2 (50% overlap), wrapped
    stride = max(1, size // 2)
    n_windows = n_units // stride
    batches = []
    for w in range(n_windows):
        start = w * stride
        batches.append(
            frozenset((start + k) % n_units for k in range(size))
        )
    worker_batch = tuple(j % n_windows for j in range(n_workers))
    # ensure every window has a worker; if more windows than workers, merge
    used = sorted(set(worker_batch))
    remap = {b: i for i, b in enumerate(used)}
    batches = tuple(batches[b] for b in used)
    worker_batch = tuple(remap[b] for b in worker_batch)
    # coverage check: windows at stride covering the ring cover everything
    return Assignment(n_workers, n_units, batches, worker_batch)


def rate_aware_assignment(
    n_workers: int, n_batches: int, rates: Sequence[float]
) -> Assignment:
    """Greedy heterogeneous-worker policy (Behrouzi-Far & Soljanin 2020 style).

    Workers have relative service rates ``rates[j]`` (higher = faster).  With
    exponential service the min over a batch's replicas is exponential with
    the batch's AGGREGATE rate, and E[T] is the expected max over batches —
    so a good assignment balances aggregate rates, not replica counts.

    Greedy: visit workers from fastest to slowest, assign each to the batch
    with the smallest aggregate rate so far (ties -> lowest batch index).
    Since N >= B the first B workers seed every batch, so each batch gets at
    least one replica.  With all rates equal this reduces to balanced
    replication counts (Thm 1's optimum).
    """
    batches = _equal_batches(n_workers, n_batches)
    if rates is None:
        raise ValueError("rates required (use balanced_nonoverlapping instead)")
    r = _validate_rates(rates, n_workers)
    # stable sort, descending rate: equal-rate workers keep index order
    order = np.argsort(-r, kind="stable")
    agg = np.zeros(n_batches)
    worker_batch = [0] * n_workers
    for j in order:
        target = int(np.argmin(agg))  # argmin ties break to lowest index
        worker_batch[int(j)] = target
        agg[target] += r[j]
    return Assignment(n_workers, n_workers, batches, tuple(worker_batch))


def random_assignment(
    n_workers: int, n_batches: int, seed: int = 0
) -> Assignment:
    """Disjoint equal batches, workers assigned uniformly at random (with the
    constraint that every batch gets >=1 worker)."""
    batches = _equal_batches(n_workers, n_batches)
    rng = np.random.default_rng(seed)
    while True:
        worker_batch = rng.integers(0, n_batches, size=n_workers)
        if len(set(worker_batch.tolist())) == n_batches:
            return Assignment(
                n_workers, n_workers, batches, tuple(int(x) for x in worker_batch)
            )
