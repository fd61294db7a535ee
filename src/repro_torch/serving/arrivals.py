"""Request arrival processes for the discrete-event serving subsystem.

The port's copy of ``repro.serving.arrivals``: pure numpy, drawing from the
caller's ``numpy`` Generator in the reference's order, so the same seed
gives the same times and labels bit for bit.

The lock-step ``serve_round`` world has no notion of WHEN requests show up —
every round starts with a full batch already waiting.  Under real traffic the
metric users feel is sojourn time (queue wait + service), and both the Aktaş
et al. clone-attack analysis and the Peng et al. diversity/parallelism
trade-off show the optimal replication level depends on the arrival process,
not just the service distribution.  This module supplies the arrival side:

* :class:`PoissonArrivals`        — memoryless traffic (the M in M/G/B);
* :class:`MMPPArrivals`           — 2-state Markov-modulated Poisson process,
                                    the standard bursty-traffic model: a slow
                                    state and a ``burstiness``-times-faster
                                    state, exponential dwell times, long-run
                                    mean pinned to ``rate``;
* :class:`DeterministicArrivals`  — fixed inter-arrival gap (D/G/B), the
                                    zero-variance anchor;
* :class:`TraceArrivals`          — replay of recorded arrival offsets, for
                                    production traces and regression pinning;
* :class:`MultiTenantArrivals`    — the north-star serving workload: several
                                    tenant classes sharing one stream, with
                                    diurnal (sinusoidal) rate modulation and
                                    Poisson-burst spikes layered on top.  Its
                                    :meth:`~MultiTenantArrivals
                                    .sample_with_classes` additionally labels
                                    each arrival with its tenant class.

Every process implements ``sample(rng, n, start) -> (n,) ascending absolute
times``; randomness comes only from the caller's ``numpy`` Generator so runs
are reproducible and common-random-number friendly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "MMPPArrivals",
    "DeterministicArrivals",
    "TraceArrivals",
    "MultiTenantArrivals",
    "make_arrivals",
]


def _validate_rate(rate: float) -> float:
    if not np.isfinite(rate) or rate <= 0:
        raise ValueError(f"arrival rate must be positive and finite, got {rate}")
    return float(rate)


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base class: a stochastic (or replayed) stream of request arrival times."""

    def sample(self, rng: np.random.Generator, n: int, start: float = 0.0) -> np.ndarray:
        """Draw ``n`` ascending absolute arrival times, the first >= ``start``."""
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run arrivals per unit time (for utilization accounting)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: i.i.d. Exp(rate) inter-arrival gaps."""

    rate: float

    def __post_init__(self):
        _validate_rate(self.rate)

    def sample(self, rng, n, start=0.0):
        gaps = rng.standard_exponential(n) / self.rate
        return start + np.cumsum(gaps)

    def mean_rate(self) -> float:
        return self.rate


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Evenly spaced arrivals at exactly ``rate`` per unit time."""

    rate: float

    def __post_init__(self):
        _validate_rate(self.rate)

    def sample(self, rng, n, start=0.0):
        return start + (1.0 + np.arange(n)) / self.rate

    def mean_rate(self) -> float:
        return self.rate


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty traffic).

    The modulating chain alternates between a slow state and a fast state
    with exponential dwell times; within a state, arrivals are Poisson at
    the state's rate.  The fast rate is ``burstiness`` times the slow rate
    and the chain spends ``burst_fraction`` of its time in the fast state,
    with the two state rates solved so the LONG-RUN mean is exactly
    ``rate`` — so an MMPP plugs into utilization accounting wherever a
    Poisson process of the same ``rate`` does, differing only in variance.
    ``mean_cycle`` is the expected slow+fast dwell per cycle, in time units.
    """

    rate: float
    burstiness: float = 4.0
    burst_fraction: float = 0.25
    mean_cycle: float = 10.0

    def __post_init__(self):
        _validate_rate(self.rate)
        if self.burstiness <= 1.0:
            raise ValueError(f"burstiness must exceed 1, got {self.burstiness}")
        if not 0.0 < self.burst_fraction < 1.0:
            raise ValueError(
                f"burst_fraction must be in (0, 1), got {self.burst_fraction}"
            )
        if self.mean_cycle <= 0:
            raise ValueError(f"mean_cycle must be positive, got {self.mean_cycle}")

    @property
    def state_rates(self) -> tuple[float, float]:
        """(slow, fast) Poisson rates with the long-run mean pinned to rate."""
        f, k = self.burst_fraction, self.burstiness
        slow = self.rate / (1.0 - f + f * k)
        return slow, k * slow

    @property
    def dwell_means(self) -> tuple[float, float]:
        """(slow, fast) expected dwell times per visit."""
        f = self.burst_fraction
        return (1.0 - f) * self.mean_cycle, f * self.mean_cycle

    def sample(self, rng, n, start=0.0):
        rates = self.state_rates
        dwells = self.dwell_means
        times = np.empty(n)
        t, state, filled = float(start), 0, 0
        while filled < n:
            dwell = rng.standard_exponential() * dwells[state]
            end = t + dwell
            # Poisson arrivals within this dwell, sequentially
            while filled < n:
                t += rng.standard_exponential() / rates[state]
                if t >= end:
                    t = end  # unused partial gap; memorylessness makes this exact
                    break
                times[filled] = t
                filled += 1
            state = 1 - state
        return times

    def mean_rate(self) -> float:
        return self.rate


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay recorded arrival offsets (relative to the trace start).

    ``sample`` shifts the trace so its first arrival lands at ``start`` and
    cycles it (each lap offset by the trace span) when ``n`` exceeds the
    trace length — a finite production trace drives arbitrarily long runs.
    """

    offsets: tuple[float, ...]

    def __post_init__(self):
        if not self.offsets:
            raise ValueError("trace must contain at least one arrival")
        o = np.asarray(self.offsets, dtype=float)
        if np.any(~np.isfinite(o)) or np.any(np.diff(o) < 0):
            raise ValueError("trace offsets must be finite and non-decreasing")
        object.__setattr__(self, "offsets", tuple(float(x) for x in o))

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "TraceArrivals":
        t = np.asarray(times, dtype=float)
        return cls(offsets=tuple(t - t[0]))

    def sample(self, rng, n, start=0.0):
        o = np.asarray(self.offsets)
        span = float(o[-1] - o[0])
        # one mean gap between laps keeps the replay strictly ordered; a
        # degenerate (single-point or zero-span) trace falls back to unit laps
        lap = span + span / (len(o) - 1) if span > 0 else 1.0
        reps = -(-n // len(o))  # ceil
        tiled = np.concatenate([o + k * lap for k in range(reps)])[:n]
        return start + tiled

    def mean_rate(self) -> float:
        o = np.asarray(self.offsets)
        if len(o) < 2 or o[-1] <= o[0]:
            return 1.0
        return (len(o) - 1) / float(o[-1] - o[0])


@dataclasses.dataclass(frozen=True)
class MultiTenantArrivals(ArrivalProcess):
    """Mixed-tenant traffic: classes + diurnal load + burst spikes.

    The north-star serving workload of the multi-tenant planner sweep.  A
    base nonhomogeneous Poisson stream carries the steady traffic, its rate
    modulated sinusoidally (``rate * (1 + diurnal_amplitude *
    sin(2*pi*t/diurnal_period))``, sampled by thinning against the peak
    rate); on top, burst EVENTS arrive as a Poisson process of rate
    ``burst_rate``, each dumping ``burst_size`` extra arrivals uniformly
    over the next ``burst_span`` time units (flash crowds).  Every arrival
    is labeled with a tenant class drawn i.i.d. from ``classes`` — a tuple
    of ``(name, share)`` pairs, shares normalized internally — via
    :meth:`sample_with_classes`; plain :meth:`sample` yields the times
    alone, so the process drops into every :class:`ArrivalProcess` slot.

    ``mean_rate`` is the long-run average including bursts, so utilization
    accounting sees the real offered load, not just the base stream.

    >>> mt = MultiTenantArrivals(rate=8.0, classes=(("premium", 1.0),
    ...                                             ("batch", 3.0)))
    >>> rng = np.random.default_rng(0)
    >>> times, labels = mt.sample_with_classes(rng, 4)
    >>> len(times), sorted(set(labels) | {"premium"})
    (4, ['batch', 'premium'])
    """

    rate: float
    classes: tuple[tuple[str, float], ...] = (("default", 1.0),)
    diurnal_amplitude: float = 0.0  # in [0, 1): rate swings +/- this fraction
    diurnal_period: float = 100.0
    burst_rate: float = 0.0  # burst events per unit time
    burst_size: int = 0  # extra arrivals dumped per burst event
    burst_span: float = 1.0  # each burst spreads over this many time units

    def __post_init__(self):
        _validate_rate(self.rate)
        cls = tuple((str(n), float(s)) for n, s in self.classes)
        if not cls:
            raise ValueError("at least one tenant class required")
        if any(s <= 0 or not np.isfinite(s) for _, s in cls):
            raise ValueError(f"class shares must be positive finite: {cls}")
        if len({n for n, _ in cls}) != len(cls):
            raise ValueError(f"duplicate class names: {cls}")
        object.__setattr__(self, "classes", cls)
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(
                f"diurnal_amplitude must be in [0, 1), got "
                f"{self.diurnal_amplitude}"
            )
        if self.diurnal_period <= 0:
            raise ValueError(
                f"diurnal_period must be positive, got {self.diurnal_period}"
            )
        if self.burst_rate < 0 or not np.isfinite(self.burst_rate):
            raise ValueError(
                f"burst_rate must be >= 0 and finite, got {self.burst_rate}"
            )
        if self.burst_size < 0:
            raise ValueError(
                f"burst_size must be >= 0, got {self.burst_size}"
            )
        if self.burst_span <= 0:
            raise ValueError(
                f"burst_span must be positive, got {self.burst_span}"
            )

    @property
    def class_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.classes)

    @property
    def class_shares(self) -> tuple[float, ...]:
        """Normalized per-class traffic fractions (sum to 1)."""
        total = sum(s for _, s in self.classes)
        return tuple(s / total for _, s in self.classes)

    def _times_in_window(self, rng, lo: float, hi: float) -> np.ndarray:
        """All arrivals (base, thinned + bursts) inside [lo, hi), sorted."""
        span = hi - lo
        peak = self.rate * (1.0 + self.diurnal_amplitude)
        n_base = rng.poisson(peak * span)
        base = lo + rng.random(n_base) * span
        if self.diurnal_amplitude > 0.0 and n_base:
            lam = self.rate * (
                1.0
                + self.diurnal_amplitude
                * np.sin(2.0 * np.pi * base / self.diurnal_period)
            )
            base = base[rng.random(n_base) * peak < lam]
        parts = [base]
        if self.burst_rate > 0.0 and self.burst_size > 0:
            n_bursts = rng.poisson(self.burst_rate * span)
            if n_bursts:
                origins = lo + rng.random(n_bursts) * span
                extra = (
                    origins[:, None]
                    + rng.random((n_bursts, self.burst_size)) * self.burst_span
                )
                parts.append(extra.ravel())
        return np.sort(np.concatenate(parts))

    def sample(self, rng, n, start=0.0):
        times: list[np.ndarray] = []
        filled, lo = 0, float(start)
        # window sized so one or two laps usually suffice; short final
        # windows keep the tail from overshooting the diurnal phase grid
        window = max((n + 1) / self.mean_rate(), self.diurnal_period)
        while filled < n:
            chunk = self._times_in_window(rng, lo, lo + window)
            times.append(chunk)
            filled += len(chunk)
            lo += window
        return np.concatenate(times)[:n]

    def sample_with_classes(
        self, rng, n, start=0.0
    ) -> tuple[np.ndarray, list[str]]:
        """Arrival times plus an i.i.d. tenant-class label per arrival."""
        times = self.sample(rng, n, start)
        edges = np.cumsum(self.class_shares)
        idx = np.searchsorted(edges, rng.random(n), side="right")
        idx = np.minimum(idx, len(self.classes) - 1)  # guard fp edge
        names = self.class_names
        return times, [names[i] for i in idx]

    def mean_rate(self) -> float:
        return self.rate + self.burst_rate * self.burst_size


def make_arrivals(kind: str, rate: float, **kwargs) -> ArrivalProcess:
    """Factory keyed by the serving-config literal.

    ``kind``: 'poisson' | 'mmpp' | 'deterministic' | 'trace' (trace requires
    ``offsets=...``) | 'multitenant'.  Extra kwargs go to the process
    constructor.
    """
    if kind == "poisson":
        return PoissonArrivals(rate=rate, **kwargs)
    if kind == "mmpp":
        return MMPPArrivals(rate=rate, **kwargs)
    if kind == "deterministic":
        return DeterministicArrivals(rate=rate, **kwargs)
    if kind == "multitenant":
        return MultiTenantArrivals(rate=rate, **kwargs)
    if kind == "trace":
        if "offsets" not in kwargs:
            raise ValueError("trace arrivals need offsets=...")
        return TraceArrivals(**kwargs)
    raise ValueError(
        f"unknown arrival kind {kind!r} "
        "(use 'poisson'|'mmpp'|'deterministic'|'trace'|'multitenant')"
    )
