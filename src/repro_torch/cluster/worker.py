"""Cluster worker process: connect, register, heartbeat, execute, report.

One worker = one OS process = one "server group" of the paper's fleet.  The
process runs three threads:

* **reader** (main)  — blocking recv loop; handles DISPATCH (enqueue work),
  CANCEL (interrupt the matching attempt), CHAOS (adopt a slowdown factor),
  RECONFIGURE (track the coordinator's generation), SHUTDOWN (exit).
* **heartbeat**      — sends HEARTBEAT every ``heartbeat_interval`` seconds
  with the currently-busy job id; a SIGSTOPped process stops beating, which
  is exactly how the coordinator detects a pause.
* **executor**       — pops the work queue one job at a time and runs the
  payload (:mod:`repro_torch.cluster.payloads`) with a per-attempt cancel event;
  reports RESULT either way (a cancelled attempt still reports its elapsed
  time — the coordinator's censoring bound).

Straggling is worker-side state: the ``--slowdown`` factor (spawn-time) or
a CHAOS message (mid-run) multiplies payload durations, invisible to the
coordinator except through measured completions — like a contended host.

``--device`` is the torch device of ``matmul`` payloads (default: none
given, which means ``"cuda"``).  It is resolved only when such a payload
runs, so a worker that only sleeps never touches CUDA; such a worker
imports no torch either, and starts in a fraction of a second.
``--load-torch`` (the harness passes it for ``matmul`` payloads) imports
torch before the worker connects: the import takes seconds, much of them
under the GIL, and in the executor thread it would hold back the
heartbeats of a worker that has registered.  A payload that
fails (a matmul payload without a card and without ``--device cpu``, for
one) is never retried elsewhere: the worker prints the traceback, closes
its connection (the coordinator sees the EOF as a death) and exits with
status 1.

Run: ``python -m repro_torch.cluster.worker --host 127.0.0.1 --port 9000``
(normally spawned by :class:`repro_torch.cluster.harness.LocalCluster`).
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import sys
import threading
import time
import traceback
from typing import Optional

from repro_torch.cluster import protocol
from repro_torch.cluster.payloads import run_payload

__all__ = ["WorkerRuntime", "run_worker", "main"]


class WorkerRuntime:
    """State + threads of one worker process (see module docstring)."""

    def __init__(
        self,
        sock: socket.socket,
        *,
        heartbeat_interval: float = 0.05,
        slowdown: float = 1.0,
        device: Optional[str] = None,
    ):
        self._sock = sock
        self.device = device
        self.error: Optional[str] = None  # traceback of a failed payload
        self._send_lock = threading.Lock()  # heartbeat + executor both send
        self._decoder = protocol.FrameDecoder()
        self.heartbeat_interval = heartbeat_interval
        self.slowdown = slowdown
        self.worker_id: Optional[int] = None
        self.generation = 0
        self._work: queue.Queue = queue.Queue()
        self._busy_job: Optional[int] = None
        # (job_id, attempt) -> cancel event for the RUNNING attempt;
        # cancelled ids linger so a CANCEL racing its DISPATCH still lands
        self._cancel_lock = threading.Lock()
        self._cancelled: set[tuple[int, int]] = set()
        self._running: dict[tuple[int, int], threading.Event] = {}
        self._stop = threading.Event()

    # -- plumbing ------------------------------------------------------------
    def _send(self, msg: dict) -> None:
        try:
            with self._send_lock:
                protocol.send_message(self._sock, msg)
        except OSError:
            # coordinator gone (or closed our socket after declaring us
            # dead): nothing to report to, shut down
            self._stop.set()

    def register(self) -> list:
        """REGISTER and consume the WELCOME.

        Returns the messages that rode in on the SAME recv as the WELCOME —
        a busy coordinator RECONFIGUREs/DISPATCHes milliseconds after
        admitting a worker, so under scheduling delay those frames land in
        one TCP read.  The caller must handle them before blocking on new
        bytes: a then-quiet coordinator would strand them (and the worker
        would heartbeat forever without ever executing its batch).
        """
        self._send({"type": protocol.REGISTER, "pid": os.getpid()})
        msgs: list = []
        while not msgs:
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("coordinator closed before WELCOME")
            msgs = list(self._decoder.feed(data))
        welcome = msgs[0]
        if welcome["type"] != protocol.WELCOME:
            raise ConnectionError(f"expected WELCOME, got {welcome!r}")
        self.worker_id = int(welcome["worker_id"])
        self.heartbeat_interval = float(
            welcome.get("heartbeat_interval", self.heartbeat_interval)
        )
        self.generation = int(welcome.get("generation", 0))
        return msgs[1:]

    # -- threads -------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            self._send(
                {
                    "type": protocol.HEARTBEAT,
                    "worker_id": self.worker_id,
                    "sent_at": time.time(),
                    "busy": self._busy_job,
                }
            )

    def _executor_loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._work.get(timeout=0.1)
            except queue.Empty:
                continue
            if msg is None:
                return
            try:
                self._execute(msg)
            except Exception:
                # a failed payload ends the worker: report loudly, drop the
                # connection so the coordinator retires this worker
                self.error = traceback.format_exc()
                print(self.error, file=sys.stderr, flush=True)
                self._stop.set()
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return

    def _execute(self, msg: dict) -> None:
        job_id, attempt = int(msg["job_id"]), int(msg["attempt"])
        key = (job_id, attempt)
        cancel = threading.Event()
        with self._cancel_lock:
            if key in self._cancelled:
                self._cancelled.discard(key)
                cancel.set()  # CANCEL arrived before we even started
            self._running[key] = cancel
        self._busy_job = job_id
        started = time.time()
        result = run_payload(
            msg["payload"],
            seed=int(msg["seed"]),
            cancel=cancel,
            slowdown=self.slowdown,
            device=self.device,
        )
        self._busy_job = None
        with self._cancel_lock:
            self._running.pop(key, None)
        report = {
            "type": protocol.RESULT,
            "worker_id": self.worker_id,
            "job_id": job_id,
            "attempt": attempt,
            "batch_id": msg.get("batch_id"),
            "generation": self.generation,
            "started": started,
            "elapsed": result["elapsed"],
            "cancelled": result["cancelled"],
            "value": result["value"],
        }
        if "device" in result:  # matmul: the device the payload ran on
            report["device"] = result["device"]
        self._send(report)

    # -- reader (main thread) ------------------------------------------------
    def _handle(self, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == protocol.DISPATCH:
            self._work.put(msg)
        elif mtype == protocol.CANCEL:
            key = (int(msg["job_id"]), int(msg["attempt"]))
            with self._cancel_lock:
                ev = self._running.get(key)
                if ev is not None:
                    ev.set()
                else:
                    self._cancelled.add(key)  # not started yet: pre-cancel
        elif mtype == protocol.CHAOS:
            self.slowdown = float(msg["slowdown"])
        elif mtype == protocol.RECONFIGURE:
            self.generation = int(msg["generation"])
        elif mtype == protocol.SHUTDOWN:
            self._stop.set()

    def run(self) -> None:
        backlog = self.register()
        threads = [
            threading.Thread(target=self._heartbeat_loop, daemon=True),
            threading.Thread(target=self._executor_loop, daemon=True),
        ]
        for t in threads:
            t.start()
        try:
            for msg in backlog:  # frames that rode in with the WELCOME
                self._handle(msg)
            while not self._stop.is_set():
                try:
                    data = self._sock.recv(65536)
                except OSError:
                    break
                if not data:
                    break  # coordinator closed the connection
                for msg in self._decoder.feed(data):
                    self._handle(msg)
        finally:
            self._stop.set()
            self._work.put(None)
            for t in threads:
                t.join(timeout=1.0)
            try:
                self._sock.close()
            except OSError:
                pass


def run_worker(
    host: str,
    port: int,
    *,
    heartbeat_interval: float = 0.05,
    slowdown: float = 1.0,
    register_delay: float = 0.0,
    connect_timeout: float = 10.0,
    device: Optional[str] = None,
) -> Optional[str]:
    """Connect to the coordinator and serve until SHUTDOWN/disconnect.

    ``register_delay`` holds the process back before connecting — the chaos
    harness's "late registration" fault (the worker joins an in-flight
    generation and is folded in at the next reconfiguration point).
    Returns the traceback of a payload that failed, else None.
    """
    if register_delay > 0:
        time.sleep(register_delay)
    sock = socket.create_connection((host, port), timeout=connect_timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    runtime = WorkerRuntime(
        sock, heartbeat_interval=heartbeat_interval, slowdown=slowdown,
        device=device,
    )
    runtime.run()
    return runtime.error


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--heartbeat-interval", type=float, default=0.05)
    ap.add_argument("--slowdown", type=float, default=1.0,
                    help="multiply every payload duration (injected straggler)")
    ap.add_argument("--register-delay", type=float, default=0.0,
                    help="sleep before connecting (late-registration chaos)")
    ap.add_argument("--device", default=None,
                    help="torch device of matmul payloads (default: cuda, "
                         "which must be present; 'cpu' runs on the host)")
    ap.add_argument("--load-torch", action="store_true",
                    help="import torch before connecting (matmul payloads)")
    args = ap.parse_args(argv)
    if args.load_torch:
        import torch  # noqa: F401
    error = run_worker(
        args.host,
        args.port,
        heartbeat_interval=args.heartbeat_interval,
        slowdown=args.slowdown,
        register_delay=args.register_delay,
        device=args.device,
    )
    return 0 if error is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
