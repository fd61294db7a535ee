"""Chaos harness: scripted faults against a running LocalCluster.

A :class:`ChaosSchedule` is a list of :class:`ChaosEvent` entries, each an
``(at, kind, worker, arg)`` tuple on the coordinator clock.  The harness
injects them while the coordinator's event loop runs, using the real OS
mechanisms a production straggler/failure would arrive through:

==========  ===============================================================
kind        mechanism
==========  ===============================================================
``kill``    SIGKILL the worker process — socket EOFs, coordinator must
            re-dispatch its in-flight batch and re-plan for the survivors
``pause``   SIGSTOP — heartbeats stop mid-batch; past ``heartbeat_timeout``
            the coordinator declares death.  ``arg`` seconds later the
            harness SIGCONTs and the worker rejoins (flap path: its stale
            RESULT must be ignored)
``slow``    CHAOS protocol message — worker multiplies payload durations by
            ``arg`` (an invisible straggler; only telemetry can see it)
``spawn``   launch one extra worker process (elastic growth / late join)
==========  ===============================================================

Injection is driven by :meth:`ChaosInjector.tick` from the same loop that
drives the coordinator (``drive()``), so event times are deterministic
relative to the run.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

from repro_torch.cluster import protocol
from repro_torch.cluster.harness import LocalCluster

__all__ = ["ChaosEvent", "ChaosInjector", "drive"]

_KINDS = ("kill", "pause", "slow", "spawn")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault.

    ``at``     — coordinator-clock seconds.
    ``kind``   — 'kill' | 'pause' | 'slow' | 'spawn'.
    ``worker`` — target worker_id ('spawn' ignores it).
    ``arg``    — pause: resume after this many seconds; slow: the factor;
                 spawn: register_delay.
    """

    at: float
    kind: str
    worker: int = 0
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} (use {_KINDS})")
        if self.at < 0:
            raise ValueError(f"event time must be >= 0, got {self.at}")
        if self.kind == "pause" and self.arg < 0:
            raise ValueError("pause resume delay must be >= 0")
        if self.kind == "slow" and self.arg <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {self.arg}")


class ChaosInjector:
    """Fires a schedule of ChaosEvents against a cluster as time passes."""

    def __init__(self, cluster: LocalCluster, events: list[ChaosEvent]):
        self.cluster = cluster
        self._events = sorted(events, key=lambda e: e.at)
        self._resumes: list[tuple[float, int]] = []  # (at, pid) SIGCONTs
        self.fired: list[ChaosEvent] = []

    def _signal(self, worker_id: int, sig: int) -> Optional[int]:
        coord = self.cluster.coordinator
        handle = coord.workers.get(worker_id)
        if handle is None or handle.pid <= 0:
            return None
        try:
            os.kill(handle.pid, sig)
        except ProcessLookupError:
            return None
        return handle.pid

    def tick(self) -> None:
        """Fire every event whose time has come (call from the drive loop)."""
        coord = self.cluster.coordinator
        now = coord.now()
        while self._events and self._events[0].at <= now:
            ev = self._events.pop(0)
            if ev.kind == "kill":
                self._signal(ev.worker, signal.SIGKILL)
            elif ev.kind == "pause":
                pid = self._signal(ev.worker, signal.SIGSTOP)
                if pid is not None and ev.arg > 0:
                    self._resumes.append((now + ev.arg, pid))
            elif ev.kind == "slow":
                coord._send(
                    ev.worker,
                    {"type": protocol.CHAOS, "slowdown": float(ev.arg)},
                )
            elif ev.kind == "spawn":
                self.cluster.spawn_worker(register_delay=ev.arg)
            self.fired.append(ev)
        still = []
        for at, pid in self._resumes:
            if at <= now:
                try:
                    os.kill(pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass
            else:
                still.append((at, pid))
        self._resumes = still

    @property
    def pending(self) -> int:
        return len(self._events) + len(self._resumes)


def drive(
    cluster: LocalCluster,
    injector: Optional[ChaosInjector] = None,
    *,
    timeout: float = 60.0,
) -> list:
    """Run the coordinator to completion, ticking the injector each lap.

    The injector piggybacks on the coordinator's poll cadence, so a fault
    scheduled at t=0.5 fires within one poll interval of 0.5s on the
    coordinator clock.  Returns the completed requests.
    """
    coord = cluster.coordinator
    deadline = coord.now() + timeout
    while coord._resolved < len(coord._submitted) or (
        injector is not None and injector.pending
    ):
        if coord.now() > deadline:
            raise TimeoutError(
                f"chaos run incomplete after {timeout}s "
                f"({coord._resolved}/{len(coord._submitted)} resolved, "
                f"{injector.pending if injector else 0} chaos events pending)"
            )
        if injector is not None:
            injector.tick()
        if (
            not any(t[2] in ("arrival", "form") for t in coord._timers)
            and len(coord._admission)
        ):
            while len(coord._admission):
                coord._form(
                    min(len(coord._admission), coord.config.batch_size)
                )
        coord._poll(0.02)
    return list(coord._submitted)
