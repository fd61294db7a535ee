"""The port's cluster runtime live: real worker processes on localhost.

Mirrors the smoke, coded-quorum and hygiene tests of
``tests/test_cluster.py`` on ``repro_torch.cluster``, with the planners on
``device="cpu"``.  The runs are wall-clock driven, so each is held to the
reference tests' own invariants (served counts, exactly-once completion,
decode exactness, process hygiene), not to timings.  A module fixture
reaps any worker a failed test leaves behind (the session reaper in
``tests/conftest.py`` knows only the reference's registry).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import math
import os
import signal

import numpy as np
import pytest

from repro_torch.cluster.chaos import ChaosEvent, ChaosInjector, drive
from repro_torch.cluster.coordinator import ClusterConfig
from repro_torch.cluster.harness import (SPAWNED_WORKER_PIDS, LocalCluster,
                                         reap_orphans)
from repro_torch.cluster.payloads import (
    coded_data_blocks,
    make_deterministic_spec,
    make_matmul_spec,
    make_sleep_spec,
)
from repro_torch.core import CodingCandidate
from repro_torch.serving.queueing import Request

TEST_TIMEOUT = 90  # wall seconds per test: failures hit it, not CI
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _reap_workers():
    yield
    reaped = reap_orphans()
    if reaped:
        print(f"\n[reaper] reaped {reaped} orphaned port worker(s)")


@pytest.fixture(autouse=True)
def _alarm_timeout():
    def _handler(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT}s wall-clock limit")

    old = signal.signal(signal.SIGALRM, _handler)
    signal.alarm(TEST_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _submit_stream(coord, n, gap, **kw):
    base = coord.now()
    for i in range(n):
        coord.submit(Request(request_id=i, arrival=base + i * gap, **kw))
    return base


# ------------------------------------------------------------------- smoke --
class TestClusterSmoke:
    def test_two_worker_deterministic_roundtrip(self):
        cfg = ClusterConfig(
            n_workers=2, n_batches=1, batch_size=1, max_wait=0.01,
            payload=make_deterministic_spec(0.03), device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            _submit_stream(coord, 6, gap=0.02)
            reqs = coord.run(timeout=20.0)
            s = coord.summary()
        assert s["served"] == 6
        assert all(math.isfinite(r.completion) for r in reqs)
        assert all(0 < r.sojourn < 5.0 for r in reqs)
        assert s["deaths"] == 0 and s["redispatches"] == 0
        for proc in cluster.procs:
            assert proc.poll() is not None

    def test_batching_coalesces_requests(self):
        cfg = ClusterConfig(
            n_workers=2, n_batches=2, batch_size=4, max_wait=0.03,
            payload=make_deterministic_spec(0.01), device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            _submit_stream(coord, 8, gap=0.001)  # burst: should batch by 4
            coord.run(timeout=20.0)
            sizes = [j.size for j in coord.completed_jobs]
        assert sum(sizes) == 8
        assert max(sizes) > 1

    def test_telemetry_feeds_tuner(self):
        cfg = ClusterConfig(
            n_workers=2, n_batches=1, batch_size=1, max_wait=0.01,
            payload=make_sleep_spec("sexp", work=1.0, delta=0.01, mu=100.0),
            device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            _submit_stream(coord, 8, gap=0.01)
            coord.run(timeout=20.0)
            assert coord.tuner is not None
            assert coord.tuner.config.device == CPU
            x, c = coord.tuner.window_observations()
        assert len(x) >= 8
        assert c.any()  # cancelled replicas arrived censored
        assert (~c).sum() >= 8  # one winner per job, uncensored
        assert np.all(x > 0)


# ------------------------------------------------------------- coded mode --
class TestCodedQuorum:
    """k-of-n coded dispatch: every job completes by DECODE from k
    distinct partials, verified against the coordinator's locally
    recomputed ground truth, with the stragglers cancelled."""

    def _run(self, coding, *, n=5, reqs=10, events=None, seed=9):
        cfg = ClusterConfig(
            n_workers=n, max_wait=0.01,
            payload=make_sleep_spec("sexp", work=1.0, delta=0.003, mu=60.0),
            heartbeat_timeout=0.3, coding=coding, seed=seed, device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            base = _submit_stream(coord, reqs, gap=0.02)
            inj = ChaosInjector(
                cluster, events(base) if events is not None else []
            )
            drive(cluster, inj, timeout=60.0)
            return coord.summary(), coord

    def test_mds_quorum_decodes_every_job(self):
        s, coord = self._run(CodingCandidate(scheme="mds", s=2))
        assert s["served"] == 10
        assert s["final_B"] == 1
        assert s["coding"] == "mds(s=2)"
        assert s["decoded_jobs"] == len(coord.completed_jobs)
        assert s["decode_failures"] == 0
        k = 5 - 2
        target = coded_data_blocks(9, k, coord.config.coding_block_dim)
        for job in coord.completed_jobs:
            np.testing.assert_allclose(
                np.asarray(job.decoded), target, atol=1e-6
            )
            won = [a for a in job.attempts
                   if a.attempt_id == job.winner_attempt]
            assert len(won) == 1 and len(won[0].values) >= k

    def test_cyclic_quorum_survives_kill(self):
        s, coord = self._run(
            CodingCandidate(scheme="cyclic", s=1),
            reqs=14,
            events=lambda base: [
                ChaosEvent(at=base + 0.15, kind="kill", worker=1)
            ],
        )
        assert s["served"] == 14
        assert s["deaths"] == 1
        assert s["decode_failures"] == 0
        assert s["decoded_jobs"] == len(coord.completed_jobs)
        n_now = len(coord._code_slot)
        assert n_now == 4
        target = coded_data_blocks(
            9, n_now, coord.config.coding_block_dim
        ).sum(axis=0)
        np.testing.assert_allclose(
            np.asarray(coord.completed_jobs[-1].decoded), target, atol=1e-5
        )


# ----------------------------------------------------------------- hygiene --
def test_spawned_pids_are_registered_and_dead():
    cfg = ClusterConfig(
        n_workers=2, n_batches=2, batch_size=1, max_wait=0.01,
        payload=make_deterministic_spec(0.01), device=CPU,
    )
    with LocalCluster(cfg) as cluster:
        pids = {p.pid for p in cluster.procs}
        assert pids <= SPAWNED_WORKER_PIDS
        coord = cluster.coordinator
        _submit_stream(coord, 2, gap=0.01)
        coord.run(timeout=15.0)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_workers_are_the_ports_and_get_the_device():
    """The harness spawns repro_torch's own worker, with --device."""
    cfg = ClusterConfig(n_workers=1, n_batches=1, device=CPU,
                        payload=make_deterministic_spec(0.01))
    with LocalCluster(cfg) as cluster:
        args = cluster.procs[0].args
    assert args[1:3] == ["-m", "repro_torch.cluster.worker"]
    assert args[-2:] == ["--device", CPU]


def test_startup_slowdowns_go_to_their_worker_ids():
    """A startup straggle factor lands on its worker_id, whatever order the
    fleet registered in (the reference keys it by spawn index)."""
    cfg = ClusterConfig(n_workers=3, n_batches=3, batch_size=1,
                        max_wait=0.005, payload=make_deterministic_spec(0.02),
                        device=CPU)
    with LocalCluster(cfg, slowdowns={2: 10.0}) as cluster:
        coord = cluster.coordinator
        _submit_stream(coord, 9, gap=0.001)  # a burst: every group serves
        coord.run(timeout=30.0)
        elapsed: dict = {}
        for job in coord.completed_jobs:
            for attempt in job.attempts:
                for wid, secs in attempt.reported.items():
                    elapsed.setdefault(wid, []).append(secs)
    assert coord.summary()["served"] == 9
    assert set(elapsed) == {0, 1, 2}
    assert min(elapsed[2]) >= 0.2
    assert max(elapsed[0] + elapsed[1]) < 0.15


def test_slowdowns_outside_the_startup_fleet_are_refused():
    cfg = ClusterConfig(n_workers=2, device=CPU,
                        payload=make_deterministic_spec(0.01))
    with pytest.raises(ValueError, match="startup fleet"):
        LocalCluster(cfg, slowdowns={2: 4.0})
    with pytest.raises(ValueError, match="startup fleet"):
        LocalCluster(cfg, slowdowns={1: 4.0}, register_delays={0: 1.0})


def test_matmul_workers_load_torch_before_registering():
    """A matmul worker imports torch before it connects (--load-torch),
    so the import never holds back a registered worker's heartbeats."""
    cfg = ClusterConfig(n_workers=1, n_batches=1, device=CPU,
                        payload=make_matmul_spec(size=8))
    with LocalCluster(cfg) as cluster:
        args = cluster.procs[0].args
    assert "--load-torch" in args
    assert args[-2:] == ["--device", CPU]


def test_a_sleeping_worker_imports_no_torch():
    """The worker's import path is stdlib and numpy: a fleet of sleeping
    workers starts without loading torch (seconds a process)."""
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = ("import sys, repro_torch.cluster.worker; "
            "print(sorted(m for m in ('torch', 'repro_torch.device', "
            "'repro_torch.cluster.coordinator') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_worker_process_exits_nonzero_on_a_matmul_without_a_card():
    """A worker spawned without --device on a host with no card fails its
    matmul payload loudly: it drops the connection and exits 1."""
    import socket
    import subprocess
    import sys

    import torch

    from repro_torch.cluster import protocol

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    with socket.create_server(("127.0.0.1", 0)) as listener:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.cluster.worker", "--port",
             str(listener.getsockname()[1])], env=env,
            stderr=subprocess.PIPE, text=True)
        SPAWNED_WORKER_PIDS.add(proc.pid)
        listener.settimeout(30.0)
        conn, _ = listener.accept()
        with conn:
            dec = protocol.FrameDecoder()
            assert protocol.recv_message(conn, dec)["type"] == \
                protocol.REGISTER
            conn.sendall(protocol.encode_message(
                {"type": protocol.WELCOME, "worker_id": 0,
                 "heartbeat_interval": 0.05, "generation": 0})
                + protocol.encode_message(
                {"type": protocol.DISPATCH, "job_id": 0, "attempt": 0,
                 "payload": make_matmul_spec(size=8), "seed": 0,
                 "deadline": None}))
            _, err = proc.communicate(timeout=30.0)
    assert proc.returncode == 1
    assert "no CUDA device is visible" in err
