"""Wall-clock cluster coordinator: the serving master over real sockets.

This is the :class:`~repro_torch.serving.queueing.EventDrivenMaster`'s dispatch
logic re-hosted on a real transport: N worker *processes* (one per "server
group" of the paper) connect over localhost TCP, and every event the
simulated master schedules on its virtual clock — batch formation under
max-wait + max-size, replica dispatch with first-replica-wins cancellation,
speculative clones / relaunches / hedges, drain-then-swap reconfiguration —
here happens at the time the operating system actually delivers it.  The
scheduling policy layer is SHARED with the simulated master
(:class:`~repro_torch.serving.queueing.AdmissionQueue`,
:func:`~repro_torch.serving.queueing.late_threshold`, the
:class:`~repro_torch.core.policies.PolicyCandidate` vocabulary), so a policy
validated in simulation runs unchanged against real stragglers.

Dispatch model.  The fleet of one *generation* is partitioned into
``n_groups`` replica-sets of ``r = N / B`` workers.  A formed batch is
DISPATCHed to every worker of one idle set; the first successful RESULT
completes the batch and every other replica (across all of the job's
attempts) receives CANCEL — cancelled workers report their elapsed time,
which is exactly the right-censored observation the paper's telemetry rule
prescribes (:func:`~repro_torch.core.simulator.censored_observations`).

Failure model.  A worker is dead when its socket EOFs (SIGKILL) or its
heartbeat gap exceeds ``heartbeat_timeout`` (SIGSTOP, livelock).  Death
retires the worker from its replica-set and censors its in-flight
observation at the detection instant; a batch whose every replica died is
re-queued (requests are never lost).  Each membership change routes
through :class:`~repro_torch.distributed.fault.FaultManager` (mark_dead ->
plan_recovery) and :class:`~repro_torch.distributed.elastic.RescaleExecutor`, a
drain-then-swap reconfiguration rebuilds the replica-sets for the
survivors, and a worker that reappears (SIGCONT after a flap) or registers
late is folded in at the next quiesce point — its stale results are
ignored, so a flap can never double-complete a batch.

Coded mode.  With ``ClusterConfig.coding`` set the dispatch fabric flips
from first-replica-wins to a k-of-n RESULT quorum: the fleet forms ONE
group of all N workers, each DISPATCH carries a per-worker coefficient row
of the scheme's encode matrix (cyclic gradient coding or the real-valued
MDS/polynomial Vandermonde — :mod:`repro_torch.core.coding`), workers regenerate
the data blocks from a seed and return their coded partial, and the
coordinator decodes as soon as ANY ``k = N - s`` distinct partials arrive —
verifying the decoded value against the ground truth it recomputes locally
— then CANCELs the ``s`` stragglers.  Coding IS the straggler mitigation
here, so speculative policies and the B-retuning loop are rejected at
config time; worker deaths shrink the fleet and the code is rebuilt for
the survivors at the same drain-then-swap point.

Telemetry closes the loop: measured completions (cancellation- and
kill-censored) feed :meth:`~repro_torch.core.tuner.StragglerTuner.observe_tagged`,
formation rates feed ``observe_load``, sojourns feed ``observe_sojourn`` —
the tuner fits service distributions from WALL-CLOCK data, KS-gates them,
and re-plans (B, policy); adopted re-plans apply at the same
drain-then-swap point as fault recovery.

Device.  ``ClusterConfig.device`` is the torch device of every planner the
coordinator runs (its own, the tuner's, each generation's fault manager's
recovery planner) and of the workers' ``matmul`` payloads.  None means
``"cuda"``: the coordinator raises ``RuntimeError`` at construction when no
card is visible, and ``"cpu"`` runs the plans on the host.  On a card the
coordinator initialises the device and runs each planning route once at
N=2 before the fleet registers (:meth:`ClusterCoordinator._warm_device`),
so no cold context or first kernel load stalls the event loop.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import selectors
import socket
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.cluster import protocol
from repro_torch.cluster.payloads import (
    coded_data_blocks,
    make_coded_spec,
    make_sleep_spec,
)
from repro_torch.core import (
    ClusterSpec,
    CodingCandidate,
    CyclicGradientCode,
    Exponential,
    HeterogeneousPlanner,
    MDSCode,
    Metric,
    Objective,
    PolicyCandidate,
    ReplicationPlan,
    ServiceDistribution,
    ShiftedExponential,
    SimulatedPlanner,
    StragglerTuner,
    TunerConfig,
    censored_observations,
    make_planner,
)
from repro_torch.core.policies import Assignment
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import RescaleExecutor, RuntimeTopology
from repro_torch.distributed.fault import FaultManager
from repro_torch.serving.queueing import (
    AdmissionQueue,
    ClonePolicy,
    QueuePolicy,
    RelaunchPolicy,
    Request,
    late_threshold,
)

__all__ = ["ClusterConfig", "WorkerHandle", "ClusterJob", "ClusterCoordinator"]


def payload_prior(spec: dict) -> ServiceDistribution:
    """Planning-prior service distribution of ONE work unit of ``spec``.

    The sleep payload states its own model; deterministic is approximated
    by a near-massless tail (the planner needs mu > 0); matmul has no
    model at all until the tuner fits one from telemetry.
    """
    kind = spec["kind"]
    if kind == "sleep" or (kind == "coded" and spec.get("family")):
        if spec["family"] == "sexp":
            return ShiftedExponential(delta=spec["delta"], mu=spec["mu"])
        return Exponential(mu=spec["mu"])
    if kind == "deterministic":
        return ShiftedExponential(delta=1.0, mu=1e3)
    return Exponential(mu=1.0)  # matmul / bare coded: fit from telemetry


def payload_work_units(spec: dict) -> float:
    """Nominal work units of one payload (telemetry normalization)."""
    kind = spec["kind"]
    if kind in ("sleep", "coded"):
        return float(spec["work"])
    if kind == "deterministic":
        return float(spec["duration"])
    return 1.0


def scale_payload(spec: dict, factor: int) -> dict:
    """The per-BATCH payload of ``factor`` requests sharing one dispatch."""
    kind = spec["kind"]
    if kind in ("sleep", "coded"):
        return {**spec, "work": spec["work"] * factor}
    if kind == "deterministic":
        return {**spec, "duration": spec["duration"] * factor}
    return {**spec, "repeats": spec["repeats"] * factor}


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Knobs of one coordinator run (wall-clock seconds throughout)."""

    n_workers: int = 2  # fleet size to wait for before serving
    n_batches: Optional[int] = None  # initial B (None: planner picks)
    batch_size: int = 1  # requests per batch (max size)
    max_wait: float = 0.05  # batch-formation deadline
    discipline: str = "fifo"  # admission: 'fifo' | 'priority' | 'edf'
    heartbeat_interval: float = 0.05
    heartbeat_timeout: float = 0.4  # gap past this = dead (pause/livelock)
    register_timeout: float = 15.0  # max wait for the initial fleet
    # per-REQUEST payload template (repro_torch.cluster.payloads); a batch of k
    # requests dispatches the spec scaled by k
    payload: dict = dataclasses.field(
        default_factory=lambda: make_sleep_spec(
            "sexp", work=1.0, delta=0.005, mu=50.0
        )
    )
    # control plane
    metric: Metric = "p99"
    tuner: bool = False  # re-plan (B, policy) from wall-clock telemetry
    planner_mode: str = "simulate"
    min_samples: int = 48  # tuner: don't fit with fewer observations
    cooldown: int = 12  # tuner: observations between re-plan attempts
    improvement_threshold: float = 0.05
    gof_alpha: Optional[float] = None  # KS-gate the parametric fit
    # live straggler policy + the portfolio tuner re-plans score
    policy: Optional[PolicyCandidate] = None
    policy_candidates: Optional[tuple[PolicyCandidate, ...]] = None
    clone_budget: int = 1
    min_policy_observations: int = 8  # empirical trigger calibration gate
    # coded mode: k-of-n quorum dispatch instead of first-replica-wins
    # (module docstring); requires a sleep payload (the timing model the
    # coded partials ride on), and excludes the tuner + speculative
    # policies — the code IS the straggler mitigation
    coding: Optional[CodingCandidate] = None
    coding_block_dim: int = 8  # data-block width (RESULT value length)
    seed: int = 0
    # torch device of the planners and of the workers' matmul payloads:
    # None means "cuda" (which must be present), "cpu" runs on the host
    device: Optional[str] = None

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.n_batches is not None and (
            self.n_batches < 1 or self.n_workers % self.n_batches
        ):
            raise ValueError(
                f"n_batches={self.n_batches} must divide "
                f"n_workers={self.n_workers}"
            )
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.max_wait <= 0:
            raise ValueError(f"max_wait must be positive, got {self.max_wait}")
        if self.heartbeat_timeout <= self.heartbeat_interval:
            raise ValueError(
                "heartbeat_timeout must exceed heartbeat_interval "
                f"({self.heartbeat_timeout} <= {self.heartbeat_interval})"
            )
        if self.coding is not None:
            if not isinstance(self.coding, CodingCandidate):
                raise TypeError(
                    "coding must be a repro_torch.core.CodingCandidate, "
                    f"got {type(self.coding).__name__}"
                )
            self.coding.k(self.n_workers)  # s < N or ValueError
            if self.n_batches not in (None, 1):
                raise ValueError(
                    "coded dispatch uses ONE group of all workers; "
                    f"n_batches={self.n_batches} conflicts (use None or 1)"
                )
            if self.tuner:
                raise ValueError(
                    "coded dispatch pins B=1; the tuner's (B, policy) "
                    "re-planning loop cannot run alongside it"
                )
            if self.policy is not None or self.policy_candidates:
                raise ValueError(
                    "coding IS the straggler mitigation: speculative "
                    "policies cannot run alongside the k-of-n quorum"
                )
            if self.payload.get("kind") != "sleep":
                raise ValueError(
                    "coded runs take a sleep payload as the per-unit "
                    f"timing model, got kind={self.payload.get('kind')!r}"
                )
            if self.coding_block_dim < 1:
                raise ValueError(
                    f"coding_block_dim must be >= 1, got "
                    f"{self.coding_block_dim}"
                )


@dataclasses.dataclass
class WorkerHandle:
    """Coordinator-side state of one connected worker process."""

    worker_id: int
    conn: socket.socket
    pid: int = -1
    alive: bool = True
    assigned: bool = False  # member of the current generation's groups
    last_seen: float = 0.0  # coordinator clock of the last message
    outstanding: int = 0  # DISPATCHes not yet RESULTed/acked
    registered_at: float = 0.0
    generation_joined: int = 0
    device: Optional[str] = None  # where its matmul payloads ran (RESULT)

    @property
    def idle(self) -> bool:
        return self.alive and self.outstanding == 0


@dataclasses.dataclass
class AttemptRecord:
    """One dispatch of a job onto one replica-set (primary / clone /
    relaunch / hedge / re-dispatch after a kill)."""

    attempt_id: int
    group_id: int
    workers: list[int]  # live members dispatched to
    dispatched: float
    kind: str  # 'primary'|'clone'|'relaunch'|'hedge'|'redispatch'
    active: bool = True
    reported: dict[int, float] = dataclasses.field(default_factory=dict)
    # coded mode: worker -> coded partial (the RESULT value); the attempt
    # decodes once k distinct partials have landed
    values: dict[int, list] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClusterJob:
    """A formed batch moving through the wall-clock dispatch fabric."""

    job_id: int
    requests: tuple[Request, ...]
    formed_at: float
    attempts: list[AttemptRecord] = dataclasses.field(default_factory=list)
    completed: float = math.nan
    winner_worker: int = -1
    winner_attempt: int = -1
    n_relaunches: int = 0
    n_dispatches: int = 0  # DISPATCH messages sent for this job (all attempts)
    decoded: Optional[list] = None  # coded mode: the verified decoded value

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def deadline(self) -> float:
        return min((r.deadline for r in self.requests), default=math.inf)

    @property
    def done(self) -> bool:
        return math.isfinite(self.completed)

    @property
    def dispatched(self) -> float:
        return self.attempts[0].dispatched if self.attempts else math.nan

    @property
    def service(self) -> float:
        return self.completed - self.dispatched

    @property
    def n_clones(self) -> int:
        return sum(a.kind in ("clone", "hedge") for a in self.attempts)

    def active_attempts(self) -> list[AttemptRecord]:
        return [a for a in self.attempts if a.active]


class ClusterCoordinator:
    """Master process of the multi-process cluster runtime (module doc)."""

    def __init__(self, config: ClusterConfig, host: str = "127.0.0.1"):
        self.config = config
        self.device = resolve_device(config.device)
        self._t0 = time.monotonic()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(config.n_workers + 8)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ, None)
        self._decoders: dict[socket.socket, protocol.FrameDecoder] = {}
        self._conn_worker: dict[socket.socket, int] = {}
        # fleet
        self.workers: dict[int, WorkerHandle] = {}
        self._next_worker_id = itertools.count()
        # generation (replica-set fabric)
        self.groups: list[list[int]] = []
        self._slots: list[int] = []  # worker id per FaultManager slot
        self._group_attempts: dict[int, int] = {}  # gid -> active attempts
        self.executor: Optional[RescaleExecutor] = None
        self.fault: Optional[FaultManager] = None
        self._reconfig_reasons: list[str] = []
        self._target_batches: Optional[int] = None  # tuner-chosen next B
        # queueing
        self._admission = AdmissionQueue(
            QueuePolicy(
                max_batch_size=config.batch_size,
                max_wait=config.max_wait,
                discipline=config.discipline,
            )
        )
        self._pending: deque[ClusterJob] = deque()
        self.jobs: dict[int, ClusterJob] = {}
        self._job_seq = itertools.count()
        self._attempt_seq = itertools.count()
        self._timers: list = []  # (when, seq, kind, payload)
        self._timer_seq = itertools.count()
        self._hedge_count = 0
        self._service_window: deque[float] = deque(maxlen=64)
        self._formations: deque[float] = deque(maxlen=32)
        # requests
        self._submitted: list[Request] = []
        self._resolved = 0
        # control plane
        self.policy: Optional[PolicyCandidate] = (
            config.policy
            if config.policy is not None and config.policy.enabled
            else None
        )
        self._work_unit = payload_work_units(config.payload)
        self.prior_dist = payload_prior(config.payload)
        self.planner = make_planner(
            mode=config.planner_mode, n_trials=2_000, seed=config.seed,
            device=config.device,
        )
        self.tuner: Optional[StragglerTuner] = None  # built with the fleet
        # coded mode (built with each generation; None when coding is off)
        self._code = None  # CyclicGradientCode | MDSCode
        self._code_rows: Optional[np.ndarray] = None  # (N, n_blocks)
        self._code_target: Optional[np.ndarray] = None  # ground truth
        self._code_slot: dict[int, int] = {}  # worker id -> encode row
        self._code_k = 0  # quorum size
        self._code_load = 0.0  # per-worker data units (of N total)
        # counters / event log
        self.completed_jobs: list[ClusterJob] = []
        self.decoded_jobs = 0
        self.decode_failures = 0
        self.stale_results = 0
        self.redispatches = 0
        self.clones = 0
        self.relaunches = 0
        self.hedges = 0
        self.deaths = 0
        self.rejoins = 0
        self.replans = 0
        self.events: list[tuple[float, str, object]] = []
        # kernel launches of the device warm-up (not of the served stream)
        self.warmup_launches: dict[str, int] = {}
        if self.device.type == "cuda":
            self._warm_device()

    def _warm_device(self) -> None:
        """Initialise the card and load the planners' kernels before the
        fleet registers.  A cold CUDA context or a first kernel load inside
        the event loop would hold it past ``heartbeat_timeout`` and get a
        healthy worker declared dead; so each planning route the loop can
        take (a plain and a load-aware simulated plan, a rate-aware
        recovery plan) runs once here at N=2.  Its launches are kept in
        :attr:`warmup_launches`."""
        from repro_torch.kernels import _build

        before = _build.launch_counts()
        spec = ClusterSpec(n_workers=2, dist=self.prior_dist)
        metric = self.config.metric
        sim = SimulatedPlanner(n_trials=64, seed=0, device=self.device)
        sim.plan(spec, Objective(metric=metric))
        sim.plan(spec, Objective(metric=metric, utilization=0.5))
        HeterogeneousPlanner(n_trials=64, seed=0, device=self.device).plan(
            dataclasses.replace(spec, rates=(1.0, 0.5)),
            Objective(metric=metric),
        )
        after = _build.launch_counts()
        self.warmup_launches = {
            k: after[k] - before.get(k, 0) for k in after
        }

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        return time.monotonic() - self._t0

    def _log(self, kind: str, detail: object = None) -> None:
        self.events.append((self.now(), kind, detail))

    # -- fleet membership ----------------------------------------------------
    @property
    def generation(self) -> int:
        return self.executor.topology.generation if self.executor else 0

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def live_workers(self) -> list[int]:
        return [w for w, h in self.workers.items() if h.alive]

    def _work(self, n_requests: int) -> float:
        """Work units of a batch of ``n_requests`` (tuner normalization)."""
        return self._work_unit * n_requests

    def wait_for_workers(
        self, n: Optional[int] = None, timeout: Optional[float] = None
    ) -> int:
        """Drive the event loop until ``n`` workers registered (or timeout);
        then build the first generation.  Returns the fleet size."""
        n = n if n is not None else self.config.n_workers
        deadline = self.now() + (
            timeout if timeout is not None else self.config.register_timeout
        )
        while len(self.workers) < n and self.now() < deadline:
            self._poll(min(0.05, deadline - self.now()))
        if len(self.workers) < n:
            raise TimeoutError(
                f"only {len(self.workers)}/{n} workers registered within "
                f"{self.config.register_timeout}s"
            )
        self._build_initial_generation()
        return len(self.workers)

    def _build_initial_generation(self) -> None:
        live = self.live_workers()
        n = len(live)
        if self.config.coding is not None:
            b = 1  # coded quorum: one group of all workers
        elif (
            self.config.n_batches is not None
            and n % self.config.n_batches == 0
        ):
            b = self.config.n_batches
        else:
            b = self.planner.plan(
                ClusterSpec(n_workers=n, dist=self.prior_dist),
                Objective(metric=self.config.metric),
            ).n_batches
        plan = ReplicationPlan(n_data=n, n_batches=b)
        self.executor = RescaleExecutor(
            RuntimeTopology(plan, generation=0), device=self.config.device
        )
        self._install_generation(live, b)
        cfg = self.config
        self.tuner = StragglerTuner(
            plan,
            TunerConfig(
                window_steps=256,
                min_samples=cfg.min_samples,
                cooldown_steps=cfg.cooldown,
                improvement_threshold=cfg.improvement_threshold,
                metric=cfg.metric,
                gof_alpha=cfg.gof_alpha,
                device=cfg.device,
            ),
            planner=self.planner,
            job_load=self._work(cfg.batch_size),
            **(
                {"policy_candidates": cfg.policy_candidates}
                if cfg.policy_candidates
                else (
                    {"policy_candidates": (self.policy,)}
                    if self.policy is not None
                    and self.policy.kind in ("relaunch", "hedged")
                    else {
                        "speculation_quantiles": (
                            (self.policy.quantile,)
                            if self.policy is not None
                            and self.policy.kind == "clone"
                            else None
                        )
                    }
                )
            ),
        )

    def _install_generation(self, live: Sequence[int], n_batches: int) -> None:
        """Partition ``live`` workers into ``n_batches`` replica-sets
        (replica-major, like the simulated master's fabric) and notify."""
        live = sorted(live)
        r = len(live) // n_batches
        self.groups = [
            list(live[g * r : (g + 1) * r]) for g in range(n_batches)
        ]
        self._group_attempts = {g: 0 for g in range(n_batches)}
        self._slots = list(live)
        if self.config.coding is not None:
            self._build_code(live)
        self.fault = FaultManager(
            ReplicationPlan(n_data=len(live), n_batches=n_batches),
            heartbeat_misses_fatal=1,
            device=self.config.device,
        )
        for w in live:
            self.workers[w].assigned = True
        msg = {
            "type": protocol.RECONFIGURE,
            "generation": self.generation,
            "n_groups": n_batches,
        }
        for w in live:
            self._send(w, msg)
        self._log("generation", {"gen": self.generation, "B": n_batches,
                                 "workers": list(live)})

    def _build_code(self, live: Sequence[int]) -> None:
        """(Re)build the encode matrix + ground truth for ``live`` workers.

        Runs at every generation install: deaths shrink the fleet, so the
        code is recut for the survivors (``s`` clamps to N-1 when the fleet
        falls below the configured tolerance).  Worker -> encode-row binding
        goes through ``_code_slot`` so rows stay stable within a generation
        even when a member dies before a dispatch.
        """
        cand = self.config.coding
        n = len(live)
        s = min(cand.s, n - 1)
        k = n - s
        if cand.scheme == "cyclic":
            self._code = CyclicGradientCode(
                n_workers=n, s=s, seed=self.config.seed
            )
            rows = self._code.coefficients()  # (N, N) over N blocks
            n_blocks, self._code_load = n, float(s + 1)
        else:  # mds / poly share the Vandermonde k-of-n geometry
            self._code = MDSCode(n=n, k=k)
            rows = self._code.generator()  # (N, k) over k blocks
            n_blocks, self._code_load = k, n / k
        blocks = coded_data_blocks(
            self.config.seed, n_blocks, self.config.coding_block_dim
        )
        self._code_rows = rows
        self._code_target = (
            blocks.sum(axis=0) if cand.scheme == "cyclic" else blocks
        )
        self._code_slot = {w: i for i, w in enumerate(sorted(live))}
        self._code_k = k
        self._log("code", {"scheme": cand.scheme, "n": n, "k": k,
                           "load": self._code_load})

    # -- socket plumbing -----------------------------------------------------
    def _send(self, worker_id: int, msg: dict) -> None:
        handle = self.workers.get(worker_id)
        if handle is None or not handle.alive:
            return
        try:
            protocol.send_message(handle.conn, msg)
        except OSError:
            self._on_worker_death(worker_id, reason="send-failed")

    def _poll(self, timeout: float) -> None:
        """One event-loop lap: sockets, due timers, dispatch."""
        next_timer = self._timers[0][0] if self._timers else math.inf
        wait = max(0.0, min(timeout, next_timer - self.now()))
        for key, _ in self._selector.select(wait):
            if key.fileobj is self._listener:
                self._accept()
            else:
                self._read(key.fileobj)
        self._fire_timers()
        self._check_heartbeats()
        self._maybe_apply_reconfig()
        self._try_dispatch()

    def _accept(self) -> None:
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return
        conn.setblocking(False)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._decoders[conn] = protocol.FrameDecoder()
        self._selector.register(conn, selectors.EVENT_READ, None)

    def _read(self, conn: socket.socket) -> None:
        try:
            data = conn.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            wid = self._conn_worker.get(conn)
            self._drop_conn(conn)
            if wid is not None:
                self._on_worker_death(wid, reason="eof")
            return
        try:
            msgs = list(self._decoders[conn].feed(data))
        except ValueError:
            wid = self._conn_worker.get(conn)
            self._drop_conn(conn)
            if wid is not None:
                self._on_worker_death(wid, reason="protocol-error")
            return
        for msg in msgs:
            self._handle(conn, msg)

    def _drop_conn(self, conn: socket.socket) -> None:
        try:
            self._selector.unregister(conn)
        except (KeyError, ValueError):
            pass
        self._decoders.pop(conn, None)
        self._conn_worker.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    # -- message handling ----------------------------------------------------
    def _handle(self, conn: socket.socket, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == protocol.REGISTER:
            self._on_register(conn, msg)
            return
        wid = self._conn_worker.get(conn)
        if wid is None:
            return  # pre-registration chatter
        handle = self.workers[wid]
        handle.last_seen = self.now()
        if not handle.alive:
            # a flapped worker (paused past the timeout, declared dead) is
            # beating again: fold it back in at the next quiesce point; its
            # retired attempt stays retired (no double-completion)
            handle.alive = True
            handle.assigned = False
            self.rejoins += 1
            self._log("rejoin", wid)
            self._request_reconfig("rejoin")
        if mtype == protocol.RESULT:
            self._on_result(wid, msg)

    def _on_register(self, conn: socket.socket, msg: dict) -> None:
        wid = next(self._next_worker_id)
        handle = WorkerHandle(
            worker_id=wid,
            conn=conn,
            pid=int(msg.get("pid", -1)),
            last_seen=self.now(),
            registered_at=self.now(),
            generation_joined=self.generation,
        )
        self.workers[wid] = handle
        self._conn_worker[conn] = wid
        try:
            protocol.send_message(
                conn,
                {
                    "type": protocol.WELCOME,
                    "worker_id": wid,
                    "heartbeat_interval": self.config.heartbeat_interval,
                    "generation": self.generation,
                },
            )
        except OSError:
            self._drop_conn(conn)
            handle.alive = False
            return
        self._log("join", wid)
        if self.executor is not None:
            # late registration: joins the in-flight generation's fleet at
            # the next drain-then-swap point
            self._request_reconfig("join")

    def _on_result(self, wid: int, msg: dict) -> None:
        handle = self.workers[wid]
        handle.outstanding = max(0, handle.outstanding - 1)
        job = self.jobs.get(int(msg["job_id"]))
        attempt = None
        if job is not None:
            for a in job.attempts:
                if a.attempt_id == int(msg["attempt"]):
                    attempt = a
                    break
        if job is None or attempt is None:
            self.stale_results += 1
            return
        attempt.reported[wid] = float(msg["elapsed"])
        if msg.get("device") is not None:
            handle.device = msg["device"]
        if msg.get("cancelled"):
            return  # cancel ack: worker freed above, telemetry already cut
        if job.done or not attempt.active:
            # a racing attempt lost after the job completed, or the attempt
            # was retired (relaunch/flap) — never double-complete
            self.stale_results += 1
            return
        if self.config.coding is not None:
            self._on_coded_result(job, attempt, wid, msg)
            return
        self._complete_job(job, attempt, wid, float(msg["elapsed"]))

    def _on_coded_result(
        self, job: ClusterJob, attempt: AttemptRecord, wid: int, msg: dict
    ) -> None:
        """k-of-n quorum: bank the partial; at k distinct partials decode,
        verify against the locally-recomputed ground truth, complete the
        job (which CANCELs the stragglers) with the k-th reporter as the
        winner — its arrival IS the completion instant."""
        value = msg.get("value")
        if value is not None and wid in self._code_slot:
            attempt.values[wid] = value
        if len(attempt.values) < self._code_k:
            return
        reporters = sorted(attempt.values, key=self._code_slot.__getitem__)
        alive = np.zeros(len(self._code_slot), dtype=bool)
        alive[[self._code_slot[w] for w in reporters]] = True
        partials = np.asarray([attempt.values[w] for w in reporters])
        weights = self._code.decode_weights(alive)
        decoded = None if weights is None else (
            weights @ partials
            if self.config.coding.scheme == "cyclic"
            else np.tensordot(weights, partials, axes=(1, 0))
        )
        ok = decoded is not None and np.allclose(
            decoded, self._code_target, atol=1e-6
        )
        if not ok and len(attempt.values) < len(attempt.workers):
            return  # rank-deficient quorum: wait for another partial
        if ok:
            self.decoded_jobs += 1
            job.decoded = np.asarray(decoded).tolist()
        else:
            self.decode_failures += 1
            self._log("decode-failure", job.job_id)
        self._complete_job(job, attempt, wid, float(msg["elapsed"]))

    # -- dispatch ------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Schedule one request's arrival (offsets on the coordinator
        clock; submit before or during :meth:`run`)."""
        self._submitted.append(request)
        self._push_timer(request.arrival, "arrival", request)

    def _push_timer(self, when: float, kind: str, payload) -> None:
        heapq.heappush(
            self._timers, (float(when), next(self._timer_seq), kind, payload)
        )

    def _fire_timers(self) -> None:
        while self._timers and self._timers[0][0] <= self.now():
            _, _, kind, payload = heapq.heappop(self._timers)
            if kind == "arrival":
                self._on_arrival(payload)
            elif kind == "form":
                if payload in self._admission:
                    self._form(min(len(self._admission),
                                   self.config.batch_size))
            elif kind == "trigger":
                self._on_trigger(payload)

    def _on_arrival(self, req: Request) -> None:
        self._admission.push(req)
        if len(self._admission) >= self.config.batch_size:
            self._form(self.config.batch_size)
        elif math.isfinite(self.config.max_wait):
            self._push_timer(
                req.arrival + self.config.max_wait, "form", req.request_id
            )

    def _form(self, k: int) -> None:
        reqs = tuple(self._admission.pop() for _ in range(k))
        job = ClusterJob(
            job_id=next(self._job_seq), requests=reqs, formed_at=self.now()
        )
        self.jobs[job.job_id] = job
        self._pending.append(job)
        self._formations.append(job.formed_at)
        if self.tuner is not None and len(self._formations) >= 2:
            span = max(self._formations) - min(self._formations)
            if span > 0:
                self.tuner.observe_load((len(self._formations) - 1) / span)

    def _group_idle(self, gid: int) -> bool:
        members = self.groups[gid]
        return (
            bool(members)
            and self._group_attempts.get(gid, 0) == 0
            and all(self.workers[w].idle for w in members)
        )

    def _pop_idle_group(self) -> Optional[int]:
        for gid in range(len(self.groups)):
            if self._group_idle(gid):
                return gid
        return None

    def _draining(self) -> bool:
        return bool(self._reconfig_reasons)

    def _try_dispatch(self) -> None:
        if self.executor is None or self._draining():
            return
        while self._pending:
            gid = self._pop_idle_group()
            if gid is None:
                return
            job = self._pending.popleft()
            if job.done:
                continue
            kind = "redispatch" if job.attempts else "primary"
            self._dispatch(job, gid, kind=kind)
            pol = self.policy
            if (
                pol is not None
                and pol.kind == "hedged"
                and self._hedge_selected(pol.hedge_fraction)
            ):
                g2 = self._pop_idle_group()
                if g2 is not None:
                    self._dispatch(job, g2, kind="hedge")
                    self.hedges += 1
            self._arm_trigger(job)

    def _hedge_selected(self, fraction: float) -> bool:
        n = self._hedge_count
        self._hedge_count += 1
        return math.floor((n + 1) * fraction) > math.floor(n * fraction)

    def _dispatch(self, job: ClusterJob, gid: int, kind: str) -> None:
        members = [w for w in self.groups[gid] if self.workers[w].alive]
        attempt = AttemptRecord(
            attempt_id=next(self._attempt_seq),
            group_id=gid,
            workers=list(members),
            dispatched=self.now(),
            kind=kind,
        )
        job.attempts.append(attempt)
        self._group_attempts[gid] = self._group_attempts.get(gid, 0) + 1
        payload = scale_payload(self.config.payload, job.size)
        deadline = job.deadline
        for slot, w in enumerate(members):
            seed = int(
                np.random.SeedSequence(
                    [self.config.seed, job.job_id, attempt.attempt_id, slot]
                ).generate_state(1)[0]
            )
            self._send(
                w,
                {
                    "type": protocol.DISPATCH,
                    "job_id": job.job_id,
                    "attempt": attempt.attempt_id,
                    "batch_id": job.job_id,
                    "payload": (
                        self._coded_payload(w, job.size)
                        if self.config.coding is not None
                        else payload
                    ),
                    "seed": seed,
                    "deadline": deadline if math.isfinite(deadline) else None,
                },
            )
            self.workers[w].outstanding += 1
            job.n_dispatches += 1
        if kind in ("primary", "redispatch"):
            for req in job.requests:
                if math.isnan(req.dispatched):
                    req.dispatched = attempt.dispatched

    def _coded_payload(self, worker_id: int, n_requests: int) -> dict:
        """This worker's coded DISPATCH payload: its encode row plus the
        sleep timing model at the coded per-worker load (a ``load(N)/N``
        share of the batch's total work — the planner's size-dependent
        service geometry on the wall clock)."""
        base = self.config.payload
        n = len(self._code_slot)
        return make_coded_spec(
            self._code_rows[self._code_slot[worker_id]],
            data_seed=self.config.seed,
            block_dim=self.config.coding_block_dim,
            family=base["family"],
            delta=base["delta"],
            mu=base["mu"],
            work=base["work"] * n_requests * self._code_load / n,
        )

    # -- straggler policy ----------------------------------------------------
    def _policy_obj(self):
        pol = self.policy
        if pol is None or not pol.enabled:
            return None
        if pol.kind == "clone":
            return ClonePolicy(
                late_quantile=pol.quantile,
                max_clones=self.config.clone_budget,
                min_observations=self.config.min_policy_observations,
            )
        if pol.kind == "relaunch":
            return RelaunchPolicy(
                late_quantile=pol.quantile,
                max_relaunches=self.config.clone_budget,
                min_observations=self.config.min_policy_observations,
            )
        return None  # hedged acts at dispatch; 'none' never acts

    def _arm_trigger(self, job: ClusterJob) -> None:
        pol = self._policy_obj()
        if pol is None:
            return
        if isinstance(pol, ClonePolicy) and job.n_clones >= pol.max_clones:
            return
        if (
            isinstance(pol, RelaunchPolicy)
            and job.n_relaunches >= pol.max_relaunches
        ):
            return
        threshold = late_threshold(pol, job, self._service_window)
        if threshold is not None and math.isfinite(threshold) and threshold > 0:
            self._push_timer(self.now() + threshold, "trigger", job.job_id)

    def _on_trigger(self, job_id: int) -> None:
        job = self.jobs.get(job_id)
        if job is None or job.done or self._draining():
            return
        if not job.active_attempts():
            return  # between re-dispatches; the new attempt re-arms
        pol = self._policy_obj()
        if pol is None:
            return  # a re-plan disabled mitigation while the timer was armed
        if isinstance(pol, RelaunchPolicy):
            if job.n_relaunches >= pol.max_relaunches:
                return
            primary = job.active_attempts()[-1]
            self._retire_attempt(job, primary, censor_at=self.now())
            job.n_relaunches += 1
            self.relaunches += 1
            self._dispatch(job, primary.group_id, kind="relaunch")
            self._log("relaunch", job_id)
            self._arm_trigger(job)
            return
        if job.n_clones >= pol.max_clones:
            return
        gid = self._pop_idle_group()
        if gid is not None:
            self._dispatch(job, gid, kind="clone")
            self.clones += 1
            self._log("clone", job_id)
        self._arm_trigger(job)  # re-arm (budget left / no idle set now)

    # -- completion + telemetry ----------------------------------------------
    def _attempt_telemetry(
        self, job: ClusterJob, attempt: AttemptRecord, bound: float
    ) -> None:
        """Feed one attempt's (possibly censored) observations to the tuner
        through the paper's cancellation rule (censored_observations)."""
        if self.tuner is None or not attempt.workers:
            return
        ids = list(attempt.workers)
        times = np.array(
            [
                attempt.reported.get(w, bound - attempt.dispatched)
                for w in ids
            ]
        )
        used = np.zeros(len(ids), dtype=bool)
        if job.winner_attempt == attempt.attempt_id:
            used[ids.index(job.winner_worker)] = True
        asg = Assignment(
            n_workers=len(ids),
            n_units=1,
            batches=(frozenset({0}),),
            worker_batch=(0,) * len(ids),
        )
        observed, censored = censored_observations(times, asg, used)
        work = self._work(job.size)
        self.tuner.observe_tagged(np.array(ids), observed / work, censored)

    def _retire_attempt(
        self, job: ClusterJob, attempt: AttemptRecord, censor_at: float
    ) -> None:
        """Cancel an attempt's replicas and record them censored at the
        retire instant (relaunch, or every replica of the attempt died)."""
        if not attempt.active:
            return
        attempt.active = False
        self._group_attempts[attempt.group_id] = max(
            0, self._group_attempts.get(attempt.group_id, 0) - 1
        )
        for w in attempt.workers:
            if w not in attempt.reported and self.workers[w].alive:
                self._send(
                    w,
                    {
                        "type": protocol.CANCEL,
                        "job_id": job.job_id,
                        "attempt": attempt.attempt_id,
                    },
                )
        self._attempt_telemetry(job, attempt, bound=censor_at)

    def _complete_job(
        self, job: ClusterJob, attempt: AttemptRecord, wid: int, elapsed: float
    ) -> None:
        job.completed = self.now()
        job.winner_worker = wid
        job.winner_attempt = attempt.attempt_id
        attempt.reported[wid] = elapsed
        for a in job.attempts:
            if not a.active:
                continue
            a.active = False
            self._group_attempts[a.group_id] = max(
                0, self._group_attempts.get(a.group_id, 0) - 1
            )
            for w in a.workers:
                if w != wid and w not in a.reported and self.workers[w].alive:
                    self._send(
                        w,
                        {
                            "type": protocol.CANCEL,
                            "job_id": job.job_id,
                            "attempt": a.attempt_id,
                        },
                    )
            self._attempt_telemetry(job, a, bound=job.completed)
        for req in job.requests:
            req.batch_id = job.job_id
            req.completion = job.completed
        self._resolved += job.size
        self.completed_jobs.append(job)
        self._service_window.append(job.service)
        if self.tuner is not None:
            self.tuner.observe_sojourn(
                np.array([req.sojourn for req in job.requests])
            )
        if self.config.tuner and self.tuner is not None:
            self._maybe_replan()

    # -- online re-planning --------------------------------------------------
    def _maybe_replan(self) -> None:
        rp = self.tuner.maybe_replan()
        if rp is not None:
            self.tuner.apply(rp)
            self.replans += 1
            if rp.plan is not None and rp.plan.objective.policies:
                pol = rp.plan.policy
                self.policy = pol if pol is not None and pol.enabled else None
            self._target_batches = rp.new_batches
            self._log(
                "replan", {"old_B": rp.old_batches, "new_B": rp.new_batches,
                           "policy": self.policy.kind if self.policy else
                           "none"}
            )
            self._request_reconfig("replan")
            return
        # policy-only switch at the same B needs no drain (mirrors the
        # serving engine's same-B adoption)
        lp = self.tuner.last_plan
        if (
            lp is not None
            and lp.n_batches == self.n_groups
            and lp.objective.policies
        ):
            pol = lp.policy
            new = pol if pol is not None and pol.enabled else None
            if (new is None) != (self.policy is None) or (
                new is not None and new != self.policy
            ):
                self.policy = new
                self._log(
                    "policy-switch", new.kind if new is not None else "none"
                )

    # -- failure handling ----------------------------------------------------
    def _check_heartbeats(self) -> None:
        if self.executor is None:
            return
        timeout = self.config.heartbeat_timeout
        for wid, handle in self.workers.items():
            if handle.alive and self.now() - handle.last_seen > timeout:
                self._on_worker_death(wid, reason="heartbeat")

    def _on_worker_death(self, wid: int, reason: str) -> None:
        handle = self.workers.get(wid)
        if handle is None or not handle.alive:
            return
        handle.alive = False
        self.deaths += 1
        self._log("death", {"worker": wid, "reason": reason})
        if reason in ("eof", "protocol-error", "send-failed"):
            self._drop_conn(handle.conn)
        if self.fault is not None and wid in self._slots:
            self.fault.mark_dead(self._slots.index(wid))
        # retire the worker from its replica-set
        for group in self.groups:
            if wid in group:
                group.remove(wid)
        # in-flight attempts: the dead replica's observation censors at the
        # detection instant; an attempt (and job) with no live replica left
        # is re-queued — accepted requests are never lost
        for job in self.jobs.values():
            if job.done:
                continue
            for attempt in job.active_attempts():
                if wid in attempt.workers and not all(
                    self.workers[w].alive for w in attempt.workers
                ):
                    live = [
                        w for w in attempt.workers if self.workers[w].alive
                    ]
                    if self.config.coding is not None:
                        # banked partials outlive their reporter; the
                        # attempt dies only when the quorum is unreachable
                        reachable = set(attempt.values) | set(live)
                        if len(reachable) < self._code_k:
                            self._retire_attempt(job, attempt,
                                                 censor_at=self.now())
                    elif not live:
                        self._retire_attempt(job, attempt,
                                             censor_at=self.now())
            if job.attempts and not job.active_attempts():
                # every replica of every attempt died: back to the queue
                # (a job still waiting in _pending keeps its single slot)
                self._pending.appendleft(job)
                self.redispatches += 1
                self._log("redispatch", job.job_id)
        if self.executor is not None:
            self._request_reconfig("death")

    # -- drain-then-swap reconfiguration -------------------------------------
    def _request_reconfig(self, reason: str) -> None:
        self._reconfig_reasons.append(reason)

    def _maybe_apply_reconfig(self) -> None:
        if not self._draining() or self.executor is None:
            return
        if any(self._group_attempts.get(g, 0) for g in range(len(self.groups))):
            return  # still draining in-flight attempts
        reasons, self._reconfig_reasons = self._reconfig_reasons, []
        live = self.live_workers()
        if not live:
            raise RuntimeError("no live workers left in the fleet")
        n = len(live)
        dist = (
            self.tuner.last_fit.dist
            if self.tuner is not None and self.tuner.last_fit is not None
            else self.prior_dist
        )
        target = self._target_batches
        self._target_batches = None
        fleet_changed = sorted(live) != sorted(self._slots)
        if self.config.coding is not None:
            # coded quorum keeps ONE group whatever the fleet size; the
            # code itself is recut for the survivors in _install_generation
            topo = self.executor.apply_replan(1)
        elif target is not None and n % target == 0 and not fleet_changed:
            topo = self.executor.apply_replan(target)
        elif "death" in reasons and self.fault is not None and not any(
            r in ("join", "rejoin") for r in reasons
        ):
            # recovery planning for the survivors, rate-aware when the
            # tagged wall-clock telemetry covers every slot
            rates = (
                self.tuner.rates_for(self._slots)
                if self.tuner is not None
                else None
            )
            plan = self.fault.plan_recovery(dist, rates=rates,
                                            metric=self.config.metric)
            topo = self.executor.apply_plan(plan)
        else:
            plan = self.planner.plan(
                ClusterSpec(n_workers=n, dist=dist),
                Objective(metric=self.config.metric),
            )
            topo = self.executor.apply_plan(plan)
        b = topo.plan.n_batches
        if n % b:  # planner plan was built for a different fleet size
            b = max(d for d in range(1, n + 1) if n % d == 0 and d <= b)
        self._install_generation(live, b)
        if self.tuner is not None:
            self.tuner.plan = ReplicationPlan(n_data=n, n_batches=b)
        self._log("reconfig", {"gen": self.generation, "B": b,
                               "reasons": reasons})

    # -- driving -------------------------------------------------------------
    def run(self, timeout: float = 60.0) -> list[Request]:
        """Serve until every submitted request completed (or ``timeout``
        wall seconds elapse -> TimeoutError).  Returns the requests."""
        deadline = self.now() + timeout
        while self._resolved < len(self._submitted):
            if self.now() > deadline:
                state = {
                    "pending": [j.job_id for j in self._pending],
                    "draining": self._reconfig_reasons,
                    "group_attempts": dict(self._group_attempts),
                    "groups": [sorted(g) for g in self.groups],
                    "outstanding": {
                        w: h.outstanding for w, h in self.workers.items()
                    },
                    "alive": {w: h.alive for w, h in self.workers.items()},
                }
                raise TimeoutError(
                    f"cluster run incomplete after {timeout}s "
                    f"({self._resolved}/{len(self._submitted)} resolved); "
                    f"state={state}; events={self.events[-40:]}"
                )
            # flush stranded partial batches once all arrivals are in
            if (
                not any(t[2] in ("arrival", "form") for t in self._timers)
                and len(self._admission)
            ):
                while len(self._admission):
                    self._form(
                        min(len(self._admission), self.config.batch_size)
                    )
            self._poll(0.05)
        return list(self._submitted)

    def shutdown(self) -> None:
        """SHUTDOWN every worker and close all sockets."""
        for wid, handle in self.workers.items():
            if handle.alive:
                try:
                    protocol.send_message(
                        handle.conn, {"type": protocol.SHUTDOWN}
                    )
                except OSError:
                    pass
        for conn in list(self._decoders):
            self._drop_conn(conn)
        try:
            self._selector.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def summary(self) -> dict:
        """Sojourn quantiles + control-plane counters of the run so far."""
        soj = np.array(
            [r.sojourn for r in self._submitted if math.isfinite(r.completion)]
        )
        out = {
            "requests": len(self._submitted),
            "served": int(soj.size),
            "mean_sojourn": float(soj.mean()) if soj.size else math.nan,
            "p50_sojourn": float(np.quantile(soj, 0.5)) if soj.size else math.nan,
            "p99_sojourn": float(np.quantile(soj, 0.99)) if soj.size else math.nan,
            "final_B": self.n_groups,
            "generation": self.generation,
            "deaths": self.deaths,
            "rejoins": self.rejoins,
            "redispatches": self.redispatches,
            "stale_results": self.stale_results,
            "clones": self.clones,
            "relaunches": self.relaunches,
            "hedges": self.hedges,
            "replans": self.replans,
            "policy": self.policy.kind if self.policy is not None else "none",
            "coding": (
                self.config.coding.describe()
                if self.config.coding is not None
                else "none"
            ),
            "decoded_jobs": self.decoded_jobs,
            "decode_failures": self.decode_failures,
        }
        return out
