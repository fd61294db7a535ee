"""The port's cluster runtime under faults: heartbeat edge cases and the
chaos matrix of ``tests/test_cluster.py``, on ``repro_torch.cluster`` with
the planners on ``device="cpu"``.

SIGKILL mid-batch, SIGSTOP past the heartbeat timeout then SIGCONT (the
flapped worker's stale RESULT must be dropped), a late registration, and
(``slow``, as in the reference) the kill / pause / slowdown-with-clones /
late-spawn / tuner matrix.  Each run is held to the reference tests'
invariants, not to timings.  A module fixture reaps any worker a failed
test leaves behind.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import os
import signal

import pytest

from repro_torch.cluster.chaos import ChaosEvent, ChaosInjector, drive
from repro_torch.cluster.coordinator import ClusterConfig
from repro_torch.cluster.harness import LocalCluster, reap_orphans
from repro_torch.cluster.payloads import (
    make_deterministic_spec,
    make_sleep_spec,
)
from repro_torch.core import PolicyCandidate
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


class TestHeartbeatEdgeCases:
    def test_worker_dies_mid_batch(self):
        """SIGKILL mid-batch: the batch is re-dispatched (no request lost)
        and the dead replica's time is recorded CENSORED at detection."""
        cfg = ClusterConfig(
            n_workers=2, n_batches=2, batch_size=1, max_wait=0.01,
            payload=make_deterministic_spec(0.4), heartbeat_timeout=0.3,
            device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            _submit_stream(coord, 4, gap=0.01)
            deadline = coord.now() + 5.0
            while not any(h.outstanding for h in coord.workers.values()):
                assert coord.now() < deadline, "no worker ever got a dispatch"
                coord._poll(0.02)
            busy = [w for w, h in coord.workers.items() if h.outstanding]
            os.kill(cluster.worker_pid(busy[0]), signal.SIGKILL)
            coord.run(timeout=30.0)
            s = coord.summary()
            x, c = coord.tuner.window_observations()
            fault = coord.fault
        assert s["served"] == 4
        assert s["deaths"] == 1
        assert s["redispatches"] >= 1
        assert s["generation"] >= 1
        assert c.any()
        assert fault.device == CPU

    def test_pause_past_timeout_then_resume_no_double_dispatch(self):
        cfg = ClusterConfig(
            n_workers=2, n_batches=2, batch_size=1, max_wait=0.01,
            payload=make_deterministic_spec(0.12), heartbeat_timeout=0.25,
            device=CPU,
        )
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            _submit_stream(coord, 24, gap=0.025)
            inj = ChaosInjector(
                cluster,
                [ChaosEvent(at=coord.now() + 0.05, kind="pause", worker=0,
                            arg=0.7)],
            )
            drive(cluster, inj, timeout=30.0)
            s = coord.summary()
            reqs = coord._submitted
        assert s["served"] == 24
        assert sorted(r.request_id for r in reqs) == list(range(24))
        assert s["deaths"] == 1 and s["rejoins"] == 1
        assert s["stale_results"] >= 1
        assert s["generation"] >= 2

    def test_late_registration_joins_next_generation(self):
        cfg = ClusterConfig(
            n_workers=3, batch_size=1, max_wait=0.01,
            payload=make_deterministic_spec(0.04), heartbeat_timeout=0.5,
            device=CPU,
        )
        with LocalCluster(cfg, register_delays={2: 1.0}) as cluster:
            coord = cluster.coordinator
            assert len(coord.workers) == 2
            _submit_stream(coord, 40, gap=0.05)
            coord.run(timeout=30.0)
            deadline = coord.now() + 15.0
            while len(coord.live_workers()) < 3 and coord.now() < deadline:
                coord._poll(0.05)
            s = coord.summary()
            live = coord.live_workers()
        assert s["served"] == 40
        assert len(live) == 3
        assert s["generation"] >= 1
        assert sum(len(g) for g in coord.groups) == 3


@pytest.mark.slow
class TestChaosMatrix:
    N = 4
    REQS = 60

    def _run(self, events, *, policy=None, tuner=False, slowdowns=None,
             settle=None):
        cfg = ClusterConfig(
            n_workers=self.N, n_batches=self.N, batch_size=1, max_wait=0.01,
            payload=make_sleep_spec("sexp", work=1.0, delta=0.01, mu=50.0),
            heartbeat_timeout=0.3, policy=policy, tuner=tuner,
            min_samples=40, planner_mode="analytic", seed=11, device=CPU,
        )
        with LocalCluster(cfg, slowdowns=slowdowns or {}) as cluster:
            coord = cluster.coordinator
            base = _submit_stream(coord, self.REQS, gap=0.02)
            inj = ChaosInjector(cluster, events(base))
            drive(cluster, inj, timeout=60.0)
            if settle is not None:
                deadline = coord.now() + 10.0
                while not settle(coord) and coord.now() < deadline:
                    coord._poll(0.05)
            return coord.summary(), coord

    def test_kill(self):
        s, _ = self._run(
            lambda base: [ChaosEvent(at=base + 0.3, kind="kill", worker=1)]
        )
        assert s["served"] == self.REQS
        assert s["deaths"] == 1 and s["generation"] >= 1

    def test_pause_resume(self):
        s, _ = self._run(
            lambda base: [
                ChaosEvent(at=base + 0.3, kind="pause", worker=2, arg=0.8)
            ]
        )
        assert s["served"] == self.REQS
        assert s["deaths"] == 1 and s["rejoins"] == 1

    def test_slowdown_with_clone_policy(self):
        s, _ = self._run(
            lambda base: [
                ChaosEvent(at=base + 0.2, kind="slow", worker=3, arg=10.0)
            ],
            policy=PolicyCandidate(kind="clone", quantile=0.9),
        )
        assert s["served"] == self.REQS
        assert s["policy"] == "clone"
        assert s["clones"] >= 1

    def test_late_spawn_grows_fleet(self):
        s, coord = self._run(
            lambda base: [ChaosEvent(at=base + 0.3, kind="spawn")],
            settle=lambda c: len(c.live_workers()) == self.N + 1
            and sum(len(g) for g in c.groups) == self.N + 1,
        )
        assert s["served"] == self.REQS
        assert len(coord.live_workers()) == self.N + 1
        assert sum(len(g) for g in coord.groups) == self.N + 1

    def test_tuner_replans_from_wall_clock_telemetry(self):
        s, coord = self._run(lambda base: [], tuner=True)
        assert s["served"] == self.REQS
        assert coord.tuner.last_fit is not None
        x, c = coord.tuner.window_observations()
        assert len(x) >= 40
