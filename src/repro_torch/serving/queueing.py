"""Event-driven serving master: admission queue, batch formation, replica
dispatch with first-replica-wins cancellation, speculative re-dispatch, and
deadline (EDF) scheduling.

The port's copy of ``repro.serving.queueing``: pure numpy and ``heapq``,
with the reference's event order, so every dispatch, completion and drop
is bit-equal to the reference's.

This is the discrete-event core the engine drives the model from.  The fleet
is factored (per the active :class:`~repro_torch.core.planner.Plan`) into
``n_groups`` replica-sets — one per batch slot, each holding ``r`` server
groups.  The master's event loop:

* **Admission** — requests enter the queue at their arrival time under one of
  four disciplines (``QueuePolicy.discipline``): ``'fifo'`` (arrival order),
  ``'priority'`` (larger ``Request.priority`` first, ties FIFO), ``'edf'``
  (earliest ``Request.deadline`` first, ties FIFO — the deadline/SLO
  discipline), or ``'wfq'`` (weighted fair queueing across ``Request.slo``
  tenant classes: each class keeps FIFO order internally and classes share
  formation slots in proportion to ``QueuePolicy.class_weights``, stride-
  scheduled so no backlogged class ever starves).  With
  ``QueuePolicy.drop_expired`` set, a request whose deadline has already
  passed is DROPPED instead of queued (at admission) or instead of
  dispatched (at batch formation); with ``QueuePolicy.queue_cap`` set, an
  arriving request finding the admission queue at capacity is shed on the
  spot (admission-control load shedding — weight-aware under ``'wfq'``,
  where a heavier-class arrival instead evicts the newest request of the
  cheapest backlogged class).  Dropped requests land in
  :attr:`EventDrivenMaster.dropped_requests` and never occupy a replica-set.
* **Batch formation** — a batch forms as soon as ``max_batch_size`` requests
  wait, or when the OLDEST queued request has waited ``max_wait`` (whichever
  comes first; the master keeps exactly one formation timer armed at
  ``oldest_arrival + max_wait`` and re-arms it after every formation, so the
  bound holds under every discipline, including the ones whose pop order is
  not arrival order); leftovers are flushed once the arrival stream ends, so
  no request is ever dropped by formation (the lock-step engine's remainder
  bug — see :func:`partition_requests`).  A batch inherits the EARLIEST
  deadline and the LARGEST priority of its requests.
* **Replica dispatch** — a formed batch goes to the lowest-numbered idle
  replica-set (under ``'priority'``/``'edf'`` an urgent batch overtakes
  earlier-formed pending ones); its ``r`` replicas all start, the FASTEST
  one's response completes the batch and the rest are cancelled (the paper's
  ``min``-over-replicas rule), so the whole set frees at the winner's time.
* **Straggler mitigation** — a :class:`StragglerPolicy` decides what to do
  about late responses, all variants sharing the same event clock,
  first-completion-wins cancellation, and censored-telemetry accounting:

  - :class:`ClonePolicy` (speculative re-dispatch, the original behavior
    and the alias :class:`SpeculationPolicy`): a batch whose first response is
    LATE (no response by the policy's late-quantile threshold after
    dispatch) is cloned onto an idle replica-set, Aktaş et al.
    clone-attack style — the clone's ``r`` replicas race the originals,
    whichever responds first completes the batch, and every other replica
    is cancelled.  Clones only ever take sets that are idle at the trigger
    instant (a queued batch is never displaced), and each job spends at
    most ``max_clones`` from its clone budget.
  - :class:`RelaunchPolicy`: a late batch's in-flight replica set is
    CANCELLED and the batch re-dispatches fresh on the same set (no extra
    capacity consumed; Behrouzi-Far/Soljanin 2020's relaunch arm, which
    pays off only when service has memory — under Exp it is a
    distributional no-op).  Discarded attempts are kept, censored at the
    relaunch instant, for telemetry.
  - :class:`HedgedDispatchPolicy`: a deterministic-stride fraction of jobs
    dispatches to ``k`` replica-sets UP FRONT (primary + hedges racing
    from t=0), spending idle capacity at dispatch time instead of waiting
    for a late signal.
  - :class:`NoOpPolicy`: never intervene (explicit baseline).
* **Sojourn accounting** — every request records arrival, dispatch, and
  completion; sojourn = queue wait + service, the metric the load-aware
  planner objectives act on.  Requests carrying a finite ``deadline`` also
  report :attr:`Request.missed_deadline`.

Re-planning: ``on_job_complete`` may return a reconfiguration (new
``n_groups``, sampler, and/or ``policy`` — a replacement
:class:`QueuePolicy` with the same discipline/weights, so a swept
``max_wait`` or shed cap lands on the live master).  The master then DRAINS — formed batches keep
queueing, in-flight batches finish, no new clones launch — and swaps the
replica-set fabric only at the quiesce point, mirroring how re-factoring a
real mesh flushes compiled executables before traffic resumes.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "QueuePolicy",
    "StragglerPolicy",
    "NoOpPolicy",
    "ClonePolicy",
    "SpeculationPolicy",
    "RelaunchPolicy",
    "HedgedDispatchPolicy",
    "Request",
    "BatchJob",
    "AdmissionQueue",
    "EventDrivenMaster",
    "job_observations",
    "late_threshold",
    "partition_requests",
]


def partition_requests(n_requests: int, n_batches: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) request slices for one synchronized round.

    The legacy ``serve_round`` sliced ``per_batch = max(n // B, 1)`` requests
    per batch and DROPPED the remainder (``n=10, B=4`` served only 8).  Here
    the LAST batch absorbs the remainder, so every request is assigned; with
    ``B | n`` the slices are identical to the legacy ones.  Empty trailing
    slices (``n < B``) are preserved so callers can keep slice index == batch
    index.

    >>> partition_requests(10, 4)
    [(0, 2), (2, 4), (4, 6), (6, 10)]
    """
    if n_batches < 1:
        raise ValueError(f"n_batches must be >= 1, got {n_batches}")
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    per_batch = max(n_requests // n_batches, 1)
    slices = []
    for bi in range(n_batches):
        lo = min(bi * per_batch, n_requests)
        hi = min((bi + 1) * per_batch, n_requests)
        if bi == n_batches - 1:
            hi = n_requests  # the remainder rides with the last batch
        slices.append((lo, hi))
    return slices


@dataclasses.dataclass(frozen=True)
class QueuePolicy:
    """Admission + batch-formation knobs of the event-driven master.

    * ``max_batch_size`` — form a batch as soon as this many requests wait.
    * ``max_wait``       — ... or when the OLDEST queued request has waited
      this long.  The master keeps one formation timer armed at
      ``oldest_arrival + max_wait`` (re-armed after every formation), so
      the bound is oldest-waiting under EVERY discipline — including
      ``'edf'``/``'priority'``/``'wfq'``, whose pop order is not arrival
      order.
    * ``discipline``     — ``'fifo'`` | ``'priority'`` (larger
      :attr:`Request.priority` first) | ``'edf'`` (earliest
      :attr:`Request.deadline` first; requests without a deadline sort last)
      | ``'wfq'`` (weighted fair queueing across :attr:`Request.slo` tenant
      classes, see ``class_weights``).
    * ``class_weights``  — ``((class_name, weight), ...)`` fair-share
      weights for ``'wfq'`` (hashable so planner sweeps can carry it).
      Classes not listed get weight 1.0; under sustained backlog each
      class's share of formation slots converges to its weight fraction,
      and no backlogged class ever starves (stride scheduling).
    * ``drop_expired``   — drop a request whose deadline has already passed
      instead of admitting/dispatching it (the SLO "don't serve dead work"
      knob; default off, so late requests are still served and merely
      counted as deadline misses).
    * ``queue_cap``      — admission-control load shedding: an arriving
      request finding this many requests already queued is dropped instead
      of admitted (bounds queue wait under overload; ``None`` = unbounded).
      Under ``'wfq'`` the shedding is weight-aware: an arrival of a
      heavier class evicts the NEWEST queued request of the cheapest
      backlogged class instead of being shed itself (see
      :meth:`AdmissionQueue.evict_for`), so overload pressure lands on the
      low-weight tenants first.  A cap also THROTTLES size-triggered
      formation to ``n_groups`` pending batches (see
      :meth:`EventDrivenMaster._maybe_form`): overload backlog then
      accumulates in the admission queue where the cap acts, instead of
      draining into the unbounded formed-batch buffer.

    >>> QueuePolicy(max_batch_size=8, discipline="edf", drop_expired=True)
    QueuePolicy(max_batch_size=8, max_wait=inf, discipline='edf', class_weights=None, drop_expired=True, queue_cap=None)
    """

    max_batch_size: int = 4  # form a batch as soon as this many wait
    max_wait: float = math.inf  # ... or the oldest has waited this long
    discipline: str = "fifo"  # 'fifo' | 'priority' | 'edf' | 'wfq'
    class_weights: Optional[tuple] = None  # ((slo, weight), ...) for 'wfq'
    drop_expired: bool = False  # drop requests already past their deadline
    queue_cap: Optional[int] = None  # shed arrivals beyond this queue length

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}"
            )
        if not self.max_wait > 0:
            raise ValueError(f"max_wait must be positive, got {self.max_wait}")
        if self.discipline not in ("fifo", "priority", "edf", "wfq"):
            raise ValueError(
                f"unknown discipline {self.discipline!r} "
                "(use 'fifo'|'priority'|'edf'|'wfq')"
            )
        if self.class_weights is not None:
            if self.discipline != "wfq":
                raise ValueError(
                    "class_weights only applies to the 'wfq' discipline"
                )
            cw = tuple((str(n), float(w)) for n, w in self.class_weights)
            if any(w <= 0 or not math.isfinite(w) for _, w in cw):
                raise ValueError(
                    f"class weights must be positive finite, got {cw}"
                )
            if len({n for n, _ in cw}) != len(cw):
                raise ValueError(f"duplicate class names in {cw}")
            object.__setattr__(self, "class_weights", cw)
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError(
                f"queue_cap must be >= 1, got {self.queue_cap}"
            )


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Base class of the master's straggler-mitigation policies.

    One policy instance is wired into :class:`EventDrivenMaster` (the
    ``speculation=`` / ``straggler_policy=`` knob); concrete subclasses are
    :class:`ClonePolicy` (and its legacy alias :class:`SpeculationPolicy`),
    :class:`RelaunchPolicy`, :class:`HedgedDispatchPolicy`, and
    :class:`NoOpPolicy`.  All share the master's event clock,
    first-completion-wins cancellation, and censored-telemetry accounting.
    """


@dataclasses.dataclass(frozen=True)
class NoOpPolicy(StragglerPolicy):
    """Never intervene — the explicit do-nothing baseline (equivalent to
    running the master with no policy at all, but nameable in configs and
    planner sweeps)."""


def _validate_trigger_fields(pol) -> None:
    """Shared validation of the late-trigger knobs (clone + relaunch)."""
    if not 0.0 < pol.late_quantile < 1.0:
        raise ValueError(
            f"late_quantile must be in (0, 1), got {pol.late_quantile}"
        )
    if pol.min_observations < 1:
        raise ValueError(
            f"min_observations must be >= 1, got {pol.min_observations}"
        )


@dataclasses.dataclass(frozen=True)
class ClonePolicy(StragglerPolicy):
    """When (and how much) to clone a late batch (speculative re-dispatch).

    A batch dispatched at time ``t`` whose first response has not arrived by
    ``t + threshold`` is LATE; the master then launches a clone of the whole
    batch on an idle replica-set (if one exists), first-replica-wins across
    originals and clones.  The threshold is, in order of preference:

    * ``threshold(job)`` — caller-supplied model, e.g. the ``late_quantile``
      of the fitted min-over-replicas service distribution (what the serving
      engine wires in); or
    * the empirical ``late_quantile`` of the master's own window of observed
      batch service times, once ``min_observations`` jobs have completed
      (self-calibrating fallback when no fitted model is available).

    ``max_clones`` is the per-job clone budget: after a clone launches, the
    trigger re-arms one threshold later until the budget is spent.  Clones
    are launched ONLY onto sets idle at the trigger instant — speculation
    spends spare capacity, never displaces queued work.

    >>> ClonePolicy(late_quantile=0.9, max_clones=1)
    ClonePolicy(late_quantile=0.9, max_clones=1, min_observations=8, threshold=None)
    """

    late_quantile: float = 0.9  # trigger when the response is this late
    max_clones: int = 1  # per-job clone budget
    min_observations: int = 8  # window size gating the empirical fallback
    threshold: Optional[Callable[["BatchJob"], float]] = None

    def __post_init__(self):
        _validate_trigger_fields(self)
        if self.max_clones < 0:
            raise ValueError(
                f"max_clones must be >= 0, got {self.max_clones}"
            )


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy(ClonePolicy):
    """Pre-portfolio name of :class:`ClonePolicy`, kept as an alias so
    existing configs and pickles keep working (see docs/migration.md)."""


@dataclasses.dataclass(frozen=True)
class RelaunchPolicy(StragglerPolicy):
    """Cancel a late batch's in-flight attempt and re-dispatch it FRESH.

    Same late-trigger machinery as :class:`ClonePolicy` (caller-supplied
    ``threshold`` model, else the empirical ``late_quantile`` of observed
    batch services), but instead of spending an extra replica-set the
    master CANCELS the running replicas and draws a brand-new attempt on
    the same set.  No extra capacity is consumed, so relaunch helps exactly
    when service has memory (the elapsed wait predicts a long remainder) —
    under exponential service it is a distributional no-op, the regime
    boundary Behrouzi-Far/Soljanin 2020 pins.  ``max_relaunches`` bounds
    attempts per job; discarded attempts are kept on the job, censored at
    the relaunch instant, for telemetry.

    >>> RelaunchPolicy(late_quantile=0.9)
    RelaunchPolicy(late_quantile=0.9, max_relaunches=1, min_observations=8, threshold=None)
    """

    late_quantile: float = 0.9  # trigger when the response is this late
    max_relaunches: int = 1  # per-job relaunch budget
    min_observations: int = 8  # window size gating the empirical fallback
    threshold: Optional[Callable[["BatchJob"], float]] = None

    def __post_init__(self):
        _validate_trigger_fields(self)
        if self.max_relaunches < 0:
            raise ValueError(
                f"max_relaunches must be >= 0, got {self.max_relaunches}"
            )


@dataclasses.dataclass(frozen=True)
class HedgedDispatchPolicy(StragglerPolicy):
    """Dispatch a job to ``k`` replica-sets UP FRONT (hedged requests).

    A deterministic-stride ``hedge_fraction`` of dispatched jobs grabs up
    to ``k - 1`` ADDITIONAL idle replica-sets at dispatch time (job ``n``
    is hedged iff ``floor((n+1)f) > floor(nf)`` — reproducible, no RNG);
    all sets race from t=0, first response wins, the rest are cancelled.
    Hedges only take sets idle at the dispatch instant, so queued work is
    never displaced — hedging converts spare capacity into tail latency up
    front instead of waiting for a late signal, which wins under
    heavy-tailed service and loses under light load-sensitive regimes.

    >>> HedgedDispatchPolicy(k=2, hedge_fraction=0.5)
    HedgedDispatchPolicy(k=2, hedge_fraction=0.5)
    """

    k: int = 2  # replica-sets per hedged job (primary + k-1 hedges)
    hedge_fraction: float = 1.0  # fraction of jobs hedged (stride-selected)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not 0.0 <= self.hedge_fraction <= 1.0:
            raise ValueError(
                f"hedge_fraction must be in [0, 1], got {self.hedge_fraction}"
            )


@dataclasses.dataclass
class Request:
    """One user request moving through the queueing subsystem.

    ``priority`` matters under the ``'priority'`` discipline (larger = more
    urgent); ``deadline`` (ABSOLUTE sim-time, default +inf = no SLO) drives
    the ``'edf'`` discipline, drop-on-expiry, and miss accounting; ``slo`` is
    a free-form class label for per-class reporting.  ``dropped`` marks a
    request shed by drop-on-expiry — it never ran, so its ``completion``
    stays NaN.

    >>> r = Request(request_id=0, arrival=1.0, deadline=3.0)
    >>> r.dispatched, r.completion = 1.5, 2.5
    >>> r.sojourn, r.missed_deadline
    (1.5, False)
    """

    request_id: int
    arrival: float
    priority: float = 0.0  # larger = more urgent ('priority' discipline only)
    deadline: float = math.inf  # absolute SLO deadline ('edf' + miss stats)
    slo: str = ""  # optional SLO class label (reporting only)
    batch_id: int = -1
    dispatched: float = math.nan
    completion: float = math.nan
    dropped: bool = False  # shed by drop-on-expiry, never served

    @property
    def queue_wait(self) -> float:
        return self.dispatched - self.arrival

    @property
    def sojourn(self) -> float:
        """Queue wait + service: the latency the user actually feels."""
        return self.completion - self.arrival

    @property
    def missed_deadline(self) -> bool:
        """True when the request has a deadline and did not make it (a
        dropped request counts as a miss; one still in flight does not)."""
        if not math.isfinite(self.deadline):
            return False
        return self.dropped or (
            math.isfinite(self.completion) and self.completion > self.deadline
        )


@dataclasses.dataclass
class BatchJob:
    """A formed batch of requests and its dispatch/telemetry record.

    One job occupies one replica-set (``group``) from ``dispatched`` until
    ``completed``; speculative clones AND up-front hedges occupy additional
    sets, recorded in the parallel lists ``clone_groups`` /
    ``clone_dispatched`` / ``clone_service_times``.  ``winner`` is the
    fastest ORIGINAL replica; ``winner_clone`` is -1 when an original won
    and otherwise the index of the winning clone/hedge (whose fastest
    replica supplied the result).  Under :class:`RelaunchPolicy`, cancelled
    attempts move to ``discarded_service_times`` (their relaunch instants
    in ``relaunched_at``) and ``service_times`` always holds the CURRENT
    attempt's draws.
    """

    batch_id: int
    requests: tuple[Request, ...]
    formed_at: float
    group: int = -1  # replica-set the batch ran on
    dispatched: float = math.nan
    completed: float = math.nan
    service_times: Optional[np.ndarray] = None  # per-replica draws
    winner: int = -1  # index of the fastest original replica
    # speculative re-dispatch record (parallel lists, one entry per clone)
    clone_groups: list[int] = dataclasses.field(default_factory=list)
    clone_dispatched: list[float] = dataclasses.field(default_factory=list)
    clone_service_times: list[np.ndarray] = dataclasses.field(
        default_factory=list
    )
    winner_clone: int = -1  # -1: an original replica won; else clone index
    # relaunch record (parallel lists, one entry per cancelled attempt)
    relaunched_at: list[float] = dataclasses.field(default_factory=list)
    discarded_service_times: list[np.ndarray] = dataclasses.field(
        default_factory=list
    )
    departed: bool = False  # internal: guards stale depart events

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def priority(self) -> float:
        """A batch is as urgent as its most urgent request."""
        return max((r.priority for r in self.requests), default=0.0)

    @property
    def deadline(self) -> float:
        """A batch inherits the EARLIEST deadline of its requests (EDF)."""
        return min((r.deadline for r in self.requests), default=math.inf)

    @property
    def service(self) -> float:
        """Dispatch-to-completion time (clone wins shorten it)."""
        return self.completed - self.dispatched

    @property
    def n_clones(self) -> int:
        """How many speculative clones / hedges this job launched."""
        return len(self.clone_groups)

    @property
    def n_relaunches(self) -> int:
        """How many times this job's attempt was cancelled and re-drawn."""
        return len(self.relaunched_at)

    @property
    def attempt_dispatched(self) -> float:
        """Dispatch time of the CURRENT attempt on the original set (equals
        ``dispatched`` unless the job relaunched)."""
        return self.relaunched_at[-1] if self.relaunched_at else self.dispatched

    @property
    def attempt_service(self) -> float:
        """Current-attempt dispatch-to-completion time — the censoring bound
        for the live ``service_times`` draws (equals ``service`` unless the
        job relaunched)."""
        return self.completed - self.attempt_dispatched

    @property
    def groups(self) -> list[int]:
        """Every replica-set the job occupies (original + clones)."""
        return [self.group, *self.clone_groups]

    def used_mask(self) -> np.ndarray:
        """Per-ORIGINAL-replica mask: True for the replica whose result was
        used (all False when a speculative clone won the race)."""
        used = np.zeros(len(self.service_times), dtype=bool)
        if self.winner_clone < 0:
            used[self.winner] = True
        return used


class AdmissionQueue:
    """The master's admission queue, factored transport-agnostic.

    Orders waiting requests under a :class:`QueuePolicy` discipline —
    ``'fifo'`` (arrival order), ``'priority'`` (larger
    :attr:`Request.priority` first, ties FIFO), ``'edf'`` (earliest
    :attr:`Request.deadline` first, ties FIFO), or ``'wfq'`` (weighted fair
    queueing: per-:attr:`Request.slo` FIFO lanes, stride-scheduled by
    ``QueuePolicy.class_weights`` so backlogged classes share pops in
    weight proportion and none starves).  It holds NO clock and NO
    dispatch state, so the same class backs both the simulated-clock
    :class:`EventDrivenMaster` and the wall-clock
    wall-clock cluster coordinator of the cluster runtime (drop-on-expiry
    stays with the caller, who owns the clock).

    >>> q = AdmissionQueue(QueuePolicy(discipline="edf"))
    >>> q.push(Request(request_id=0, arrival=0.0, deadline=9.0))
    >>> q.push(Request(request_id=1, arrival=1.0, deadline=2.0))
    >>> q.pop().request_id, len(q)
    (1, 1)
    """

    def __init__(self, policy: QueuePolicy):
        self.policy = policy
        self._queue: deque[Request] = deque()  # fifo order
        self._prio: list = []  # (key, Request) heap: 'priority'/'edf' order
        self._queued_ids: set[int] = set()
        # oldest-waiting lookup (max_wait timers): lazily-cleaned min-heap,
        # valid under every discipline (pops leave stale entries behind)
        self._arrival_heap: list[tuple[float, int]] = []
        # 'wfq' state: per-class FIFO lanes + stride-scheduler pass values
        self._lanes: dict[str, deque[Request]] = {}
        self._pass: dict[str, float] = {}
        self._vclock = 0.0  # pass of the most recently popped class
        self._weights = dict(policy.class_weights or ())

    def __len__(self) -> int:
        return len(self._queued_ids)

    def __contains__(self, request_id: int) -> bool:
        return request_id in self._queued_ids

    def _key(self, req: Request) -> tuple:
        if self.policy.discipline == "priority":
            return (-req.priority, req.arrival, req.request_id)
        return (req.deadline, req.arrival, req.request_id)  # 'edf'

    def push(self, req: Request) -> None:
        if self.policy.discipline == "fifo":
            self._queue.append(req)
        elif self.policy.discipline == "wfq":
            lane = self._lanes.setdefault(req.slo, deque())
            if not lane:
                # a class (re)activating joins at the current virtual time:
                # it cannot burst ahead on pass credit accrued while idle
                self._pass[req.slo] = max(
                    self._pass.get(req.slo, 0.0), self._vclock
                )
            lane.append(req)
        else:
            heapq.heappush(self._prio, (self._key(req), req))
        self._queued_ids.add(req.request_id)
        heapq.heappush(self._arrival_heap, (req.arrival, req.request_id))

    def _pop_wfq(self) -> Request:
        best = None
        for name, lane in self._lanes.items():
            if not lane:
                continue
            key = (self._pass[name], lane[0].arrival, name)
            if best is None or key < best:
                best = key
        name = best[2]
        req = self._lanes[name].popleft()
        self._vclock = self._pass[name]
        self._pass[name] += 1.0 / self._weights.get(name, 1.0)
        return req

    def pop(self) -> Request:
        if self.policy.discipline == "fifo":
            req = self._queue.popleft()
        elif self.policy.discipline == "wfq":
            req = self._pop_wfq()
        else:
            req = heapq.heappop(self._prio)[1]
        self._queued_ids.discard(req.request_id)
        return req

    def oldest_arrival(self) -> float:
        """Arrival time of the longest-waiting queued request (``inf`` when
        empty) — the quantity ``max_wait`` formation timers key on."""
        h = self._arrival_heap
        while h and h[0][1] not in self._queued_ids:
            heapq.heappop(h)
        return h[0][0] if h else math.inf

    def evict_for(self, req: Request) -> Optional[Request]:
        """Pick a queued victim to shed so an arriving ``req`` can be
        admitted at capacity (weight-aware load shedding).

        Under ``'wfq'``: the NEWEST request of the cheapest backlogged
        class (smallest weight, ties by name) is evicted — but only when
        its class weighs strictly less than ``req``'s, so equal-weight
        classes never evict each other and the newcomer is shed instead
        (``None``).  Under every other discipline the queue has no class
        structure, so the newcomer is always the victim (``None`` — plain
        tail drop).
        """
        if self.policy.discipline != "wfq":
            return None
        w_new = self._weights.get(req.slo, 1.0)
        best = None
        for name, lane in self._lanes.items():
            if not lane:
                continue
            key = (self._weights.get(name, 1.0), name)
            if best is None or key < best:
                best = key
        if best is None or best[0] >= w_new:
            return None
        victim = self._lanes[best[1]].pop()
        self._queued_ids.discard(victim.request_id)
        return victim


def late_threshold(
    policy: StragglerPolicy,
    job: "BatchJob",
    service_window: Sequence[float],
) -> Optional[float]:
    """Lateness threshold for one job under a trigger-driven policy.

    Caller-supplied ``policy.threshold`` model first, else the empirical
    ``late_quantile`` of the caller's window of observed batch service
    times once ``min_observations`` have accumulated, else None (not yet
    calibrated -> no trigger).  Shared by the simulated master and the
    wall-clock cluster coordinator, so both calibrate identically.
    """
    if policy.threshold is not None:
        return float(policy.threshold(job))
    if len(service_window) >= policy.min_observations:
        return float(
            np.quantile(np.asarray(service_window), policy.late_quantile)
        )
    return None


def job_observations(job: "BatchJob") -> list[tuple[np.ndarray, np.ndarray]]:
    """Censoring-correct telemetry of one completed job: (times, censored).

    Cancelled replicas are only OBSERVED up to their cancellation instant —
    recording them censored AT that bound keeps a censored MLE unbiased
    (their full would-have-been draws would drag the fitted rate down by
    the censoring fraction).  Covers all three attempt records:

    * the live attempt (winner uncensored; a relaunched job's live draws
      censor at :attr:`BatchJob.attempt_service`, not the full sojourn);
    * relaunch-discarded attempts (every replica censored at its relaunch
      instant);
    * speculative clones / hedges (censored at THEIR cancellation time;
      only a winning clone's fastest replica is uncensored).

    Times are unnormalized (the caller divides by the batch's work units
    before feeding :meth:`repro_torch.core.tuner.StragglerTuner.observe`).
    """
    used = job.used_mask()
    observed = np.minimum(job.service_times, job.attempt_service)
    out = [(observed, ~used)]
    starts = [job.dispatched, *job.relaunched_at]
    for k, attempt in enumerate(job.discarded_service_times):
        horizon = starts[k + 1] - starts[k]
        out.append(
            (np.minimum(attempt, horizon), np.ones(len(attempt), dtype=bool))
        )
    for k in range(job.n_clones):
        clone_cancel = job.completed - job.clone_dispatched[k]
        clone_times = job.clone_service_times[k]
        clone_used = np.zeros(len(clone_times), dtype=bool)
        if job.winner_clone == k:
            clone_used[int(np.argmin(clone_times))] = True
        out.append((np.minimum(clone_times, clone_cancel), ~clone_used))
    return out


# sampler(job, group) -> per-replica service times for dispatching `job` on
# replica-set `group` (clone dispatches use the same sampler)
ServiceSampler = Callable[[BatchJob, int], np.ndarray]
# callback(job) -> None, or {'n_groups': int, 'service_sampler': fn?} to
# request a drain-then-reconfigure
JobCallback = Callable[[BatchJob], Optional[dict]]


class EventDrivenMaster:
    """The serving master as a discrete-event system (see module docstring).

    >>> master = EventDrivenMaster(2, lambda job, g: np.array([0.5, 1.0]))
    >>> master.submit(Request(request_id=0, arrival=0.0))
    >>> jobs = master.run()
    >>> jobs[0].requests[0].sojourn
    0.5
    """

    def __init__(
        self,
        n_groups: int,
        service_sampler: ServiceSampler,
        policy: Optional[QueuePolicy] = None,
        clock: float = 0.0,
        on_job_complete: Optional[JobCallback] = None,
        speculation: Optional[StragglerPolicy] = None,
        on_drop: Optional[Callable[[Request], None]] = None,
        straggler_policy: Optional[StragglerPolicy] = None,
    ):
        if n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {n_groups}")
        if speculation is not None and straggler_policy is not None:
            raise ValueError(
                "pass either speculation= or its alias straggler_policy=, "
                "not both"
            )
        self.n_groups = n_groups
        self.policy = policy or QueuePolicy()
        self.speculation = (
            speculation if speculation is not None else straggler_policy
        )
        self._sampler = service_sampler
        self.clock = float(clock)
        self.on_job_complete = on_job_complete
        # fires the moment drop-on-expiry sheds a request, so SLO telemetry
        # reaches re-plan triggers DURING the stream, not after it ends
        self.on_drop = on_drop
        self._events: list = []  # (time, seq, kind, payload)
        self._seq = itertools.count()
        self._admission = AdmissionQueue(self.policy)
        # formed batches awaiting an idle set: FIFO, or (under 'priority' /
        # 'edf') a heap keyed so the most urgent batch overtakes
        # earlier-formed ones at dispatch
        self._pending: list = []
        self._idle: list[int] = list(range(n_groups))
        heapq.heapify(self._idle)
        self._in_flight: dict[int, BatchJob] = {}
        self._batch_seq = itertools.count()
        self._timer_due = math.inf  # earliest pending max_wait timer
        self._reconfig: Optional[dict] = None
        self.completed_jobs: list[BatchJob] = []
        self.dropped_requests: list[Request] = []
        self.reconfigurations = 0
        self.speculations = 0  # clones actually launched
        self.relaunches = 0  # late attempts cancelled + re-drawn
        self.hedges = 0  # extra sets taken at dispatch time
        self._hedge_count = 0  # dispatch counter driving the hedge stride
        # observed batch service times: the empirical late-threshold fallback
        self._service_window: deque[float] = deque(maxlen=64)

    # -- submission ----------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Admit one request at its arrival time (admission + formation
        policies apply)."""
        self._push(request.arrival, "arrival", request)

    def submit_formed(
        self,
        requests: Sequence[Request],
        at: Optional[float] = None,
        service_times: Optional[np.ndarray] = None,
    ) -> BatchJob:
        """Enqueue a PRE-FORMED batch, bypassing admission and formation.

        The compatibility shim uses this to drive one synchronized round:
        ``service_times`` (per-replica) may be pre-drawn so the shim's RNG
        stream matches the legacy engine draw-for-draw.
        """
        t = self.clock if at is None else float(at)
        job = BatchJob(
            batch_id=next(self._batch_seq),
            requests=tuple(requests),
            formed_at=t,
        )
        if service_times is not None:
            job.service_times = np.asarray(service_times, dtype=float)
        self._push(t, "formed", job)
        return job

    # -- event loop ----------------------------------------------------------
    def run(self) -> list[BatchJob]:
        """Process events until every submitted request has completed."""
        while True:
            self._try_dispatch()
            if not self._events:
                if self._n_queued():
                    # arrival stream ended with a partial batch waiting:
                    # flush it (in max_batch_size chunks) rather than strand it
                    while self._n_queued():
                        self._form(min(self._n_queued(), self.policy.max_batch_size))
                    continue
                if self._pending or self._in_flight:
                    # in-flight batches always hold a depart event, and
                    # pending batches with every set idle dispatch above —
                    # reaching here means a reconfig drain resolves next lap
                    continue
                break
            t, _, kind, payload = heapq.heappop(self._events)
            self.clock = max(self.clock, t)
            if kind == "arrival":
                self._on_arrival(payload)
            elif kind == "timer":
                self._on_timer(payload)
            elif kind == "formed":
                self._pending_push(payload)
            elif kind == "depart":
                self._on_depart(payload)
            elif kind == "spec":
                self._on_spec(payload)
        return self.completed_jobs

    # -- internals -----------------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (float(t), next(self._seq), kind, payload))

    def _n_queued(self) -> int:
        return len(self._admission)

    def _drop(self, req: Request) -> None:
        req.dropped = True
        self.dropped_requests.append(req)
        if self.on_drop is not None:
            self.on_drop(req)

    def _on_arrival(self, req: Request) -> None:
        if self.policy.drop_expired and req.deadline < req.arrival:
            # already expired at admission: never queue dead work
            self._drop(req)
            return
        cap = self.policy.queue_cap
        if cap is not None and self._n_queued() >= cap:
            # admission-control shedding: the queue is at capacity.  Under
            # 'wfq' a heavier-class arrival evicts the newest request of
            # the cheapest backlogged class instead of being shed itself.
            victim = self._admission.evict_for(req)
            if victim is None:
                self._drop(req)
                return
            self._drop(victim)
        self._admission.push(req)
        self._maybe_form()
        self._arm_wait_timer()

    def _maybe_form(self) -> None:
        """Size-triggered formation, throttled under admission control.

        Without a ``queue_cap`` formation is eager: every
        ``max_batch_size``-full queue forms immediately (formed batches
        buffer unboundedly awaiting idle sets).  With a cap, eager
        formation would drain the admission queue into that unbounded
        buffer and make the cap cosmetic — overload backlog must stay IN
        the admission queue, where the cap and WFQ eviction act.  So
        size-triggered formation only runs while fewer than ``n_groups``
        batches await dispatch; ``max_wait`` timers and the end-of-stream
        flush bypass the throttle, so the oldest-waiting bound holds
        regardless.  Re-checked on every departure (freed capacity pulls
        queued work forward).
        """
        while self._n_queued() >= self.policy.max_batch_size:
            if (
                self.policy.queue_cap is not None
                and len(self._pending) >= self.n_groups
            ):
                return
            self._form(self.policy.max_batch_size)

    def _arm_wait_timer(self) -> None:
        """Keep ONE formation timer armed at ``oldest_arrival + max_wait``.

        Oldest-waiting semantics: the timer tracks the longest-waiting
        QUEUED request (not a per-request deadline), so the ``max_wait``
        bound holds under disciplines whose pop order is not arrival order.
        ``_timer_due`` dedupes — a timer already pending at or before the
        due time is reused; stale timers re-check and re-arm harmlessly.
        """
        if not math.isfinite(self.policy.max_wait) or not self._n_queued():
            return
        due = self._admission.oldest_arrival() + self.policy.max_wait
        if due < self._timer_due:
            self._timer_due = due
            self._push(due, "timer", None)

    def _on_timer(self, _payload=None) -> None:
        # oldest-waiting formation: fire batches until no queued request
        # has waited max_wait, then re-arm for the new oldest
        self._timer_due = math.inf
        w = self.policy.max_wait
        while (
            self._n_queued()
            and self._admission.oldest_arrival() + w <= self.clock
        ):
            self._form(min(self._n_queued(), self.policy.max_batch_size))
        self._arm_wait_timer()

    def _pop_request(self) -> Request:
        return self._admission.pop()

    def _pending_key(self, job: BatchJob) -> tuple:
        if self.policy.discipline == "priority":
            return (-job.priority, job.batch_id)
        return (job.deadline, job.batch_id)  # 'edf'

    def _pending_push(self, job: BatchJob) -> None:
        if self.policy.discipline in ("priority", "edf"):
            heapq.heappush(self._pending, (self._pending_key(job), job))
        else:
            self._pending.append(job)

    def _pending_pop(self) -> BatchJob:
        if self.policy.discipline in ("priority", "edf"):
            return heapq.heappop(self._pending)[1]
        return self._pending.pop(0)

    def _form(self, k: int) -> None:
        reqs = []
        for _ in range(k):
            req = self._pop_request()
            if self.policy.drop_expired and req.deadline < self.clock:
                # expired while queued: shed at the formation boundary
                self._drop(req)
            else:
                reqs.append(req)
        if not reqs:
            return  # everything popped was dead work
        job = BatchJob(
            batch_id=next(self._batch_seq),
            requests=tuple(reqs),
            formed_at=self.clock,
        )
        self._pending_push(job)

    def _spec_threshold(self, job: BatchJob) -> Optional[float]:
        """Lateness threshold for one job (see :func:`late_threshold`)."""
        return late_threshold(self.speculation, job, self._service_window)

    def _arm_speculation(self, job: BatchJob) -> None:
        """Schedule the late-response check for a just-(re)dispatched job.

        Only the trigger-driven policies (clone, relaunch) arm; hedging
        acts at dispatch time and NoOp never acts.
        """
        pol = self.speculation
        if isinstance(pol, ClonePolicy):
            if pol.max_clones <= job.n_clones:
                return
        elif isinstance(pol, RelaunchPolicy):
            if pol.max_relaunches <= job.n_relaunches:
                return
        else:
            return
        threshold = self._spec_threshold(job)
        if threshold is not None and math.isfinite(threshold) and threshold > 0:
            self._push(self.clock + threshold, "spec", job)

    def _hedge_selected(self) -> bool:
        """Deterministic stride over dispatches: job n is hedged iff
        floor((n+1)f) > floor(nf), hitting exactly a ``hedge_fraction`` of
        jobs with no RNG (reproducible, CRN-friendly)."""
        f = self.speculation.hedge_fraction
        n = self._hedge_count
        self._hedge_count += 1
        return math.floor((n + 1) * f) > math.floor(n * f)

    def _try_dispatch(self) -> None:
        if self._reconfig is not None:
            if self._in_flight:
                return  # draining: no new dispatches until the fabric quiesces
            self._apply_reconfig()
        while self._pending and self._idle:
            job = self._pending_pop()
            group = heapq.heappop(self._idle)
            job.group = group
            job.dispatched = self.clock
            if job.service_times is None:
                job.service_times = np.asarray(
                    self._sampler(job, group), dtype=float
                )
            job.winner = int(np.argmin(job.service_times))
            # first-replica-wins: the set frees at the winner's response and
            # the remaining replicas are cancelled
            job.completed = self.clock + float(job.service_times[job.winner])
            self._in_flight[group] = job
            if (
                isinstance(self.speculation, HedgedDispatchPolicy)
                and self._hedge_selected()
            ):
                # hedged dispatch: grab up to k-1 ADDITIONAL idle sets now,
                # racing from t=0 (idle-only, queued work never displaced)
                for _ in range(self.speculation.k - 1):
                    if not self._idle:
                        break
                    g2 = heapq.heappop(self._idle)
                    times = np.asarray(self._sampler(job, g2), dtype=float)
                    job.clone_groups.append(g2)
                    job.clone_dispatched.append(self.clock)
                    job.clone_service_times.append(times)
                    self._in_flight[g2] = job
                    self.hedges += 1
                    done = self.clock + float(times.min())
                    if done < job.completed:
                        job.completed = done
                        job.winner_clone = job.n_clones - 1
            self._push(job.completed, "depart", job)
            self._arm_speculation(job)

    def _on_spec(self, job: BatchJob) -> None:
        """Late-response check: the job's first response has not arrived by
        the policy threshold -> clone onto an idle set, or relaunch."""
        if job.departed or job.completed <= self.clock:
            return  # the original responded first: the trigger is a no-op
        if self._reconfig is not None:
            return  # draining: never grow/redraw the in-flight footprint
        if isinstance(self.speculation, RelaunchPolicy):
            self._relaunch(job)
            return
        if job.n_clones >= self.speculation.max_clones:
            return  # clone budget exhausted
        if self._idle:
            group = heapq.heappop(self._idle)
            times = np.asarray(self._sampler(job, group), dtype=float)
            job.clone_groups.append(group)
            job.clone_dispatched.append(self.clock)
            job.clone_service_times.append(times)
            self._in_flight[group] = job
            self.speculations += 1
            clone_done = self.clock + float(times.min())
            if clone_done < job.completed:
                # the clone wins the race: complete earlier and cancel the
                # originals (the old depart event is ignored via `departed`)
                job.completed = clone_done
                job.winner_clone = job.n_clones - 1
                self._push(job.completed, "depart", job)
        # re-arm while budget remains (also covers "no idle set right now")
        self._arm_speculation(job)

    def _relaunch(self, job: BatchJob) -> None:
        """Cancel the job's in-flight attempt and re-dispatch it fresh on
        the SAME replica-set (no extra capacity; the cancelled attempt is
        kept, censored at the relaunch instant, for telemetry)."""
        if job.n_relaunches >= self.speculation.max_relaunches:
            return  # relaunch budget exhausted
        job.discarded_service_times.append(job.service_times)
        job.relaunched_at.append(self.clock)
        job.service_times = np.asarray(
            self._sampler(job, job.group), dtype=float
        )
        job.winner = int(np.argmin(job.service_times))
        # the fresh attempt may finish LATER than the cancelled one would
        # have; the old depart event is skipped by the completed > clock
        # stale guard in _on_depart
        job.completed = self.clock + float(job.service_times[job.winner])
        self.relaunches += 1
        self._push(job.completed, "depart", job)
        self._arm_speculation(job)

    def _on_depart(self, job: BatchJob) -> None:
        if job.departed or job.completed > self.clock:
            # stale event: a winning clone already departed this job, or a
            # relaunch moved its completion past this event's time
            return
        job.departed = True
        for group in job.groups:
            del self._in_flight[group]
            # with a reconfig pending, freed sets are NOT re-added — the
            # whole fabric is rebuilt at the quiesce point in _apply_reconfig
            if self._reconfig is None:
                heapq.heappush(self._idle, group)
        for req in job.requests:
            req.batch_id = job.batch_id
            req.dispatched = job.dispatched
            req.completion = job.completed
        self.completed_jobs.append(job)
        self._service_window.append(job.service)
        # freed capacity pulls throttled queued work forward (no-op unless
        # a queue_cap armed the formation throttle)
        self._maybe_form()
        self._arm_wait_timer()
        # every completed job reports (model work + telemetry happen in the
        # callback), including those draining out; a newer reconfig request
        # supersedes the pending one at the same quiesce point
        if self.on_job_complete is not None:
            rc = self.on_job_complete(job)
            if rc:
                self._reconfig = dict(rc)

    def swap_policy(self, new: QueuePolicy) -> None:
        """Swap the live queue policy in place (serving re-plan adoption).

        Only the scalar knobs may move — ``max_wait``, ``queue_cap``,
        ``drop_expired``, ``max_batch_size``; the admission structure
        (discipline, class weights = WFQ lane state) must survive the swap,
        so changing either raises.  A shorter ``max_wait`` re-arms the
        formation timer against the oldest queued request immediately, and
        a loosened cap/size pulls queued work forward through the
        (possibly throttled) size trigger.
        """
        if (
            new.discipline != self.policy.discipline
            or new.class_weights != self.policy.class_weights
        ):
            raise ValueError(
                "cannot change the queue discipline or class weights on a "
                "live master (queued lane state would be orphaned)"
            )
        self.policy = new
        self._admission.policy = new
        self._maybe_form()
        self._arm_wait_timer()

    def _apply_reconfig(self) -> None:
        rc, self._reconfig = self._reconfig, None
        self.n_groups = int(rc.get("n_groups", self.n_groups))
        if self.n_groups < 1:
            raise ValueError(f"reconfig n_groups must be >= 1, got {self.n_groups}")
        if "service_sampler" in rc:
            self._sampler = rc["service_sampler"]
        if "policy" in rc:
            self.swap_policy(rc["policy"])
        self._idle = list(range(self.n_groups))
        heapq.heapify(self._idle)
        self.reconfigurations += 1
