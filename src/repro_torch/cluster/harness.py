"""LocalCluster: spawn a coordinator + N worker subprocesses on localhost.

The harness owns process lifecycle so tests and benchmarks stay one
``with`` block::

    cfg = ClusterConfig(n_workers=4, payload=make_sleep_spec("sexp", ...))
    with LocalCluster(cfg) as cluster:
        for i in range(32):
            cluster.coordinator.submit(Request(request_id=i, arrival=i * 0.01))
        cluster.coordinator.run(timeout=30.0)
        print(cluster.coordinator.summary())

Workers are real OS processes (``sys.executable -m
repro_torch.cluster.worker``, given ``--device`` when the config names
one, and ``--load-torch`` when its payload is a ``matmul``) so SIGKILL/SIGSTOP chaos hits genuine process state, not a thread
pretending.  Every spawned pid is recorded in the module-level
:data:`SPAWNED_WORKER_PIDS` registry; the port's cluster tests reap any
process a crashed test leaves behind with :func:`reap_orphans` in a module
fixture.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Optional

from repro_torch.cluster import protocol
from repro_torch.cluster.coordinator import ClusterConfig, ClusterCoordinator

__all__ = ["SPAWNED_WORKER_PIDS", "LocalCluster", "reap_orphans"]

# every worker pid ever spawned in this process (never pruned: the pytest
# reaper checks liveness itself, and pids in here belong to OUR children)
SPAWNED_WORKER_PIDS: set[int] = set()


def reap_orphans(pids: Optional[set] = None, *, sigkill_wait: float = 1.0) -> int:
    """SIGKILL every still-running pid in the registry; returns the count.

    Safe against pid reuse for the common case: these are direct children,
    so until ``waitpid`` they exist as zombies at worst and the pid cannot
    be recycled.
    """
    target = SPAWNED_WORKER_PIDS if pids is None else pids
    reaped = 0
    for pid in sorted(target):
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            continue
        try:
            os.kill(pid, signal.SIGKILL)
            reaped += 1
        except (ProcessLookupError, PermissionError):
            continue
    deadline = time.monotonic() + sigkill_wait
    for pid in sorted(target):
        while time.monotonic() < deadline:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done == pid:
                break
            time.sleep(0.01)
    return reaped


class LocalCluster:
    """A coordinator plus ``config.n_workers`` worker subprocesses.

    ``slowdowns`` maps a worker_id of the startup fleet to a multiplicative
    straggle factor; ``register_delays`` maps spawn index to seconds of
    delayed registration (the delayed worker is NOT counted toward the
    startup barrier — it joins the in-flight generation later, exercising
    the late-join path).

    Worker ids follow registration order, which races when the fleet starts
    together, and the dispatcher fills the lowest idle group first: so a
    factor goes to its worker_id by a CHAOS message once the barrier has
    passed (before any dispatch), not to a spawn index, and the straggler
    sits in the same group in every run.
    """

    def __init__(
        self,
        config: ClusterConfig,
        *,
        slowdowns: Optional[dict[int, float]] = None,
        register_delays: Optional[dict[int, float]] = None,
    ):
        self.config = config
        self.slowdowns = dict(slowdowns or {})
        self.register_delays = dict(register_delays or {})
        on_time = config.n_workers - sum(
            1 for i in range(config.n_workers)
            if self.register_delays.get(i, 0.0) > 0)
        if any(w not in range(on_time) for w in self.slowdowns):
            raise ValueError(
                f"slowdowns {self.slowdowns} name worker ids outside the "
                f"startup fleet 0..{on_time - 1}")
        self.coordinator: Optional[ClusterCoordinator] = None
        self.procs: list[subprocess.Popen] = []

    def spawn_worker(
        self,
        *,
        slowdown: float = 1.0,
        register_delay: float = 0.0,
        heartbeat_interval: Optional[float] = None,
    ) -> subprocess.Popen:
        """Launch one extra worker process against the live coordinator."""
        assert self.coordinator is not None, "start() first"
        hb = (
            heartbeat_interval
            if heartbeat_interval is not None
            else self.config.heartbeat_interval
        )
        cmd = [
            sys.executable,
            "-m",
            "repro_torch.cluster.worker",
            "--host",
            self.coordinator.host,
            "--port",
            str(self.coordinator.port),
            "--heartbeat-interval",
            str(hb),
            "--slowdown",
            str(slowdown),
            "--register-delay",
            str(register_delay),
        ]
        if self.config.payload.get("kind") == "matmul":
            cmd.append("--load-torch")
        if self.config.device is not None:
            cmd += ["--device", str(self.config.device)]
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.abspath(src), env.get("PYTHONPATH")) if p
        )
        proc = subprocess.Popen(cmd, env=env)
        SPAWNED_WORKER_PIDS.add(proc.pid)
        self.procs.append(proc)
        return proc

    def start(self) -> "LocalCluster":
        self.coordinator = ClusterCoordinator(self.config)
        on_time = 0
        for i in range(self.config.n_workers):
            delay = self.register_delays.get(i, 0.0)
            self.spawn_worker(register_delay=delay)
            if delay == 0.0:
                on_time += 1
        # the startup barrier counts only prompt registrants: late workers
        # are the experiment, not the fleet
        self.coordinator.wait_for_workers(n=on_time)
        for wid, factor in sorted(self.slowdowns.items()):
            self.coordinator._send(
                wid, {"type": protocol.CHAOS, "slowdown": float(factor)})
        return self

    def worker_pid(self, worker_id: int) -> int:
        """OS pid of a registered worker (from its REGISTER message)."""
        assert self.coordinator is not None
        return self.coordinator.workers[worker_id].pid

    def stop(self) -> None:
        if self.coordinator is not None:
            self.coordinator.shutdown()
        deadline = time.monotonic() + 2.0
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        reap_orphans({p.pid for p in self.procs})

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
