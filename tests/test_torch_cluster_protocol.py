"""The port's cluster runtime off the wire: protocol, payloads, config.

Mirrors the protocol, payload and config tests of ``tests/test_cluster.py``
on ``repro_torch.cluster``, and holds the port to the reference where the
two must agree exactly: every frame ``encode_message`` writes is the
reference's byte for byte (and each package decodes the other's stream);
``payload_duration``, the coded data blocks and the coded partial
``row @ blocks`` equal the reference's; ``payload_prior``,
``payload_work_units`` and ``scale_payload`` give the reference's planning
prior, work units and per-batch payloads.  The ``matmul`` payload draws
with torch (its checksum is not the reference's by design) and never runs
on the host unless asked.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import math
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.cluster import coordinator as RCO
from repro.cluster import payloads as RPL
from repro.cluster import protocol as RPR
from repro_torch.cluster import coordinator as TCO
from repro_torch.cluster import payloads as TPL
from repro_torch.cluster import protocol as protocol
from repro_torch.cluster.coordinator import ClusterConfig, ClusterCoordinator
from repro_torch.cluster.payloads import (
    make_deterministic_spec,
    make_matmul_spec,
    make_sleep_spec,
    payload_duration,
    run_payload,
)
from repro_torch.convert import from_reference
from repro_torch.core import CodingCandidate, PolicyCandidate

TEST_TIMEOUT = 90  # wall seconds per test: failures hit it, not CI


@pytest.fixture(autouse=True)
def _alarm_timeout():
    """Per-test wall-clock limit for every test in this module."""

    def _handler(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT}s wall-clock limit")

    old = signal.signal(signal.SIGALRM, _handler)
    signal.alarm(TEST_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------- protocol --
MESSAGES = [
    {"type": protocol.REGISTER, "pid": 4242},
    {"type": protocol.WELCOME, "worker_id": 3, "heartbeat_interval": 0.05,
     "generation": 2},
    {"type": protocol.HEARTBEAT, "worker_id": 1, "sent_at": 1.7e9 + 0.125,
     "busy": None},
    {"type": protocol.DISPATCH, "job_id": 7, "attempt": 2, "batch_id": 7,
     "payload": make_sleep_spec("sexp", work=3.0, delta=0.01, mu=50.0),
     "seed": 2**63 + 11, "deadline": None},
    {"type": protocol.DISPATCH, "job_id": 8, "attempt": 0, "batch_id": 8,
     "payload": TPL.make_coded_spec([0.5, -1.0, 1e-17], data_seed=9,
                                    family="exp", mu=60.0, work=0.4),
     "seed": 0, "deadline": 12.5},
    {"type": protocol.RESULT, "worker_id": 0, "job_id": 7, "attempt": 2,
     "batch_id": 7, "generation": 1, "started": 1.7e9, "elapsed": 0.0314,
     "cancelled": False, "value": [1.0, -2.5, float(np.float32(0.1))]},
    {"type": protocol.CANCEL, "job_id": 7, "attempt": 2},
    {"type": protocol.RECONFIGURE, "generation": 4, "n_groups": 2},
    {"type": protocol.CHAOS, "slowdown": 8.0},
    {"type": protocol.SHUTDOWN},
    {"type": protocol.HEARTBEAT, "worker_id": 2, "note": "ünïcode"},
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: m["type"])
def test_frames_are_the_references_byte_for_byte(msg):
    frame = protocol.encode_message(msg)
    assert frame == RPR.encode_message(msg)
    assert list(RPR.FrameDecoder().feed(frame)) == [msg]
    assert list(protocol.FrameDecoder().feed(RPR.encode_message(msg))) == [msg]


def test_protocol_constants_are_the_references():
    assert protocol.MESSAGE_TYPES == RPR.MESSAGE_TYPES
    assert protocol.MAX_FRAME == RPR.MAX_FRAME
    assert protocol._HEADER.format == RPR._HEADER.format


class TestProtocol:
    def test_roundtrip(self):
        msg = {"type": protocol.DISPATCH, "job_id": 3, "payload": {"k": [1]}}
        dec = protocol.FrameDecoder()
        out = list(dec.feed(protocol.encode_message(msg)))
        assert out == [msg]

    def test_fragmentation_and_coalescing(self):
        msgs = [
            {"type": protocol.HEARTBEAT, "worker_id": i} for i in range(5)
        ]
        blob = b"".join(protocol.encode_message(m) for m in msgs)
        dec = protocol.FrameDecoder()
        got = []
        # drip one byte at a time: frames must survive arbitrary splits
        for i in range(len(blob)):
            got.extend(dec.feed(blob[i : i + 1]))
        assert got == msgs

    def test_many_frames_one_feed(self):
        msgs = [{"type": protocol.CANCEL, "job_id": i} for i in range(10)]
        blob = b"".join(protocol.encode_message(m) for m in msgs)
        assert list(protocol.FrameDecoder().feed(blob)) == msgs

    def test_unknown_type_rejected(self):
        with pytest.raises(ValueError, match="unknown message type"):
            protocol.encode_message({"type": "GOSSIP"})

    def test_oversize_frame_rejected(self):
        dec = protocol.FrameDecoder()
        with pytest.raises(ValueError, match="exceeds MAX_FRAME"):
            list(dec.feed(struct.pack("!I", protocol.MAX_FRAME + 1)))

    def test_malformed_payload_rejected(self):
        payload = b'{"no_type": 1}'
        dec = protocol.FrameDecoder()
        with pytest.raises(ValueError, match="malformed"):
            list(dec.feed(struct.pack("!I", len(payload)) + payload))

    def test_abandoned_iteration_keeps_frames_pending(self):
        msgs = [{"type": protocol.CANCEL, "job_id": i} for i in range(3)]
        blob = b"".join(protocol.encode_message(m) for m in msgs)
        dec = protocol.FrameDecoder()
        first = next(iter(dec.feed(blob)))  # iterator abandoned after one
        assert first == msgs[0]
        assert dec.pending == 2
        assert list(dec.feed(b"")) == msgs[1:]
        assert dec.pending == 0

    def test_dispatch_riding_with_welcome_is_executed(self):
        """WELCOME + RECONFIGURE + DISPATCH in the worker's FIRST recv: the
        backlog is executed, not stranded."""
        result, _ = _drive_runtime(
            {"type": protocol.DISPATCH, "job_id": 7, "attempt": 0,
             "payload": make_deterministic_spec(0.01), "seed": 0,
             "deadline": None})
        assert result is not None, "stranded DISPATCH never executed"
        assert result["job_id"] == 7
        assert result["generation"] == 1  # backlog RECONFIGURE adopted
        assert not result["cancelled"]
        assert "device" not in result  # a sleep RESULT is the reference's


def _drive_runtime(dispatch, device=None, timeout=10.0):
    """A WorkerRuntime on one end of a socketpair, fed WELCOME +
    RECONFIGURE + ``dispatch`` in one write; returns (its RESULT, None if
    the worker closed the connection first; the runtime) after a
    SHUTDOWN, and asserts the runtime's thread ended."""
    from repro_torch.cluster.worker import WorkerRuntime

    coord_sock, worker_sock = socket.socketpair()
    runtime = WorkerRuntime(worker_sock, heartbeat_interval=0.05,
                            device=device)
    t = threading.Thread(target=runtime.run, daemon=True)
    t.start()
    dec = protocol.FrameDecoder()
    result = None
    try:
        reg = protocol.recv_message(coord_sock, dec)
        assert reg["type"] == protocol.REGISTER
        coord_sock.sendall(b"".join(protocol.encode_message(m) for m in (
            {"type": protocol.WELCOME, "worker_id": 0,
             "heartbeat_interval": 0.05, "generation": 0},
            {"type": protocol.RECONFIGURE, "generation": 1, "n_groups": 1},
            dispatch)))
        deadline = time.time() + timeout
        while time.time() < deadline:
            msg = protocol.recv_message(coord_sock, dec)
            if msg is None:
                break
            if msg["type"] == protocol.RESULT:
                result = msg
                break
    finally:
        try:
            protocol.send_message(coord_sock, {"type": protocol.SHUTDOWN})
        except OSError:
            pass
        t.join(timeout=5.0)
        coord_sock.close()
    assert not t.is_alive()
    return result, runtime


def test_matmul_worker_reports_its_device():
    result, runtime = _drive_runtime(
        {"type": protocol.DISPATCH, "job_id": 1, "attempt": 0,
         "payload": make_matmul_spec(size=16, repeats=2), "seed": 5,
         "deadline": None}, device="cpu")
    assert result["device"] == "cpu" and math.isfinite(result["value"])
    assert runtime.error is None


def test_matmul_never_runs_on_the_host_unasked():
    """Without a card and without device='cpu' the payload raises, and a
    worker given one drops its connection with the error recorded
    instead of reporting a RESULT."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    spec = make_matmul_spec(size=16, repeats=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_payload(spec, seed=1, cancel=threading.Event())
    result, runtime = _drive_runtime(
        {"type": protocol.DISPATCH, "job_id": 1, "attempt": 0,
         "payload": spec, "seed": 5, "deadline": None})
    assert result is None
    assert "CUDA" in runtime.error


def test_failing_payload_ends_the_worker_loudly():
    """A payload that raises ends the worker with its traceback kept and
    its connection closed (the coordinator sees a death), where the
    reference's worker loses only its executor thread and keeps beating
    busy, never reporting (ROADMAP C)."""
    result, runtime = _drive_runtime(
        {"type": protocol.DISPATCH, "job_id": 1, "attempt": 0,
         "payload": {"kind": "nope"}, "seed": 0, "deadline": None})
    assert result is None
    assert "unknown payload kind 'nope'" in runtime.error


# ---------------------------------------------------------------- payloads --
SLEEP_SPECS = [
    make_sleep_spec("sexp", work=2.0, delta=0.01, mu=10.0),
    make_sleep_spec("exp", work=0.3, mu=25.0),
    make_deterministic_spec(0.05),
    TPL.make_coded_spec([1.0, 2.0], family="sexp", delta=0.003, mu=60.0,
                        work=0.75),
    TPL.make_coded_spec([1.0, 2.0]),
]


@pytest.mark.parametrize("spec", SLEEP_SPECS, ids=lambda s: s["kind"])
def test_payload_duration_is_the_references(spec):
    for seed in (0, 1, 123, 2**40 + 3, 2**63 + 5):
        assert payload_duration(spec, seed) == RPL.payload_duration(spec,
                                                                    seed)
    assert payload_duration(make_matmul_spec(), 0) is None


@pytest.mark.parametrize("seed", [0, 9, 21])
def test_coded_partials_are_the_references(seed):
    rng = np.random.default_rng(seed)
    row = rng.standard_normal(5)
    np.testing.assert_array_equal(TPL.coded_data_blocks(seed, 5, 6),
                                  RPL.coded_data_blocks(seed, 5, 6))
    spec = TPL.make_coded_spec(row, data_seed=seed, block_dim=6,
                               family="exp", mu=2000.0, work=1.0)
    assert spec == RPL.make_coded_spec(row, data_seed=seed, block_dim=6,
                                       family="exp", mu=2000.0, work=1.0)
    port = run_payload(spec, seed=seed, cancel=threading.Event())
    ref = RPL.run_payload(spec, seed=seed, cancel=threading.Event())
    assert port["value"] == ref["value"]
    assert not port["cancelled"] and not ref["cancelled"]


SPECS = [
    make_sleep_spec("sexp", work=1.0, delta=0.005, mu=50.0),
    make_sleep_spec("exp", work=2.5, mu=25.0),
    make_deterministic_spec(0.03),
    make_matmul_spec(size=64, repeats=3),
    TPL.make_coded_spec([1.0, 0.5], family="sexp", delta=0.01, mu=30.0),
    TPL.make_coded_spec([1.0, 0.5]),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["kind"])
def test_planning_prior_and_scaling_are_the_references(spec):
    assert TCO.payload_prior(spec) == from_reference(RCO.payload_prior(spec))
    assert TCO.payload_work_units(spec) == RCO.payload_work_units(spec)
    for k in (1, 3, 8):
        assert TCO.scale_payload(spec, k) == RCO.scale_payload(spec, k)


class TestPayloads:
    def test_sleep_seeded_reproducible(self):
        spec = make_sleep_spec("sexp", work=2.0, delta=0.01, mu=10.0)
        d1 = payload_duration(spec, seed=123)
        d2 = payload_duration(spec, seed=123)
        assert d1 == d2
        assert d1 >= 2.0 * 0.01  # work * delta floor
        assert payload_duration(spec, seed=124) != d1

    def test_deterministic_runs_for_duration(self):
        spec = make_deterministic_spec(0.05)
        out = run_payload(spec, seed=0, cancel=threading.Event())
        assert not out["cancelled"]
        assert out["elapsed"] == pytest.approx(0.05, abs=0.04)

    def test_cancel_interrupts_sleep(self):
        spec = make_deterministic_spec(5.0)
        cancel = threading.Event()
        t = threading.Timer(0.05, cancel.set)
        t.start()
        out = run_payload(spec, seed=0, cancel=cancel)
        t.join()
        assert out["cancelled"]
        assert out["elapsed"] < 1.0  # interrupted within a few slices

    def test_slowdown_scales_duration(self):
        spec = make_deterministic_spec(0.03)
        fast = run_payload(spec, seed=0, cancel=threading.Event())
        slow = run_payload(
            spec, seed=0, cancel=threading.Event(), slowdown=3.0
        )
        assert slow["elapsed"] > fast["elapsed"] * 1.5

    @pytest.mark.slow
    def test_matmul_produces_checksum(self):
        spec = make_matmul_spec(size=32, repeats=2)
        out = run_payload(spec, seed=7, cancel=threading.Event(),
                          device="cpu")
        assert not out["cancelled"]
        assert math.isfinite(out["value"])
        assert out["device"] == "cpu"

    def test_invalid_specs_rejected(self):
        with pytest.raises(ValueError):
            make_sleep_spec("weibull")
        with pytest.raises(ValueError):
            make_sleep_spec("exp", mu=-1.0)
        with pytest.raises(ValueError):
            make_deterministic_spec(-0.1)


def test_matmul_checksum_follows_the_stated_seed_rule():
    """torch.randn from Generator(device).manual_seed(seed % 2**31), then
    ``repeats`` times x = tanh(x @ x.T / n), summing trace(x)."""
    seed, n = 2**31 + 17, 24
    out = run_payload(make_matmul_spec(size=n, repeats=3), seed=seed,
                      cancel=threading.Event(), slowdown=1.0, device="cpu")
    x = torch.randn((n, n), generator=torch.Generator().manual_seed(17))
    acc = 0.0
    for _ in range(3):
        x = torch.tanh(x @ x.T / n)
        acc += float(torch.trace(x))
    assert out["value"] == acc
    cancelled = threading.Event()
    cancelled.set()
    out = run_payload(make_matmul_spec(size=n), seed=seed, cancel=cancelled,
                      device="cpu")
    assert out["cancelled"] and out["value"] is None


def test_coded_payload_partial_is_exact():
    row = [0.5, -1.0, 2.0, 0.0]
    spec = TPL.make_coded_spec(row, data_seed=21, block_dim=6,
                               family="exp", mu=500.0, work=1.0)
    out = run_payload(spec, seed=1, cancel=threading.Event())
    blocks = TPL.coded_data_blocks(21, 4, 6)
    np.testing.assert_allclose(out["value"], np.asarray(row) @ blocks)
    assert not out["cancelled"]
    assert payload_duration(spec, seed=1) > 0.0
    cancelled = threading.Event()
    cancelled.set()
    out = run_payload(spec, seed=1, cancel=cancelled)
    assert out["cancelled"] and out["value"] is None
    bare = TPL.make_coded_spec(row, data_seed=21, block_dim=6)
    assert payload_duration(bare, seed=0) == 0.0
    with pytest.raises(ValueError, match="non-empty"):
        TPL.make_coded_spec([])


# ------------------------------------------------------------------ config --
class TestConfig:
    def test_batches_must_divide_workers(self):
        with pytest.raises(ValueError, match="divide"):
            ClusterConfig(n_workers=4, n_batches=3)

    def test_heartbeat_timeout_exceeds_interval(self):
        with pytest.raises(ValueError, match="heartbeat_timeout"):
            ClusterConfig(heartbeat_interval=0.5, heartbeat_timeout=0.1)

    def test_registration_timeout(self):
        cfg = ClusterConfig(n_workers=1, register_timeout=0.2, device="cpu")
        coord = ClusterCoordinator(cfg)
        try:
            with pytest.raises(TimeoutError, match="registered"):
                coord.wait_for_workers()
        finally:
            coord.shutdown()


def test_coded_config_conflicts_are_loud():
    cand = CodingCandidate(scheme="mds", s=1)
    sleep = make_sleep_spec("sexp", work=1.0, delta=0.01, mu=50.0)
    with pytest.raises(ValueError, match="s=4 tolerates"):
        ClusterConfig(n_workers=4, coding=CodingCandidate("mds", s=4))
    with pytest.raises(ValueError, match="ONE group"):
        ClusterConfig(n_workers=4, n_batches=2, coding=cand)
    with pytest.raises(ValueError, match="tuner"):
        ClusterConfig(n_workers=4, coding=cand, tuner=True)
    with pytest.raises(ValueError, match="mitigation"):
        ClusterConfig(n_workers=4, coding=cand,
                      policy=PolicyCandidate(kind="clone", quantile=0.9))
    with pytest.raises(ValueError, match="sleep payload"):
        ClusterConfig(n_workers=4, coding=cand,
                      payload=make_deterministic_spec(0.01))
    with pytest.raises(TypeError, match="CodingCandidate"):
        ClusterConfig(n_workers=4, coding=("mds", 1), payload=sleep)
    ClusterConfig(n_workers=4, coding=cand, payload=sleep)  # valid


def test_config_fields_are_the_references_plus_device():
    port = {f.name: f.default for f in
            TCO.dataclasses.fields(ClusterConfig)}
    ref = {f.name: f.default for f in
           RCO.dataclasses.fields(RCO.ClusterConfig)}
    assert set(port) == set(ref) | {"device"}
    assert port["device"] is None
    assert {k: v for k, v in port.items() if k in ref} == ref


def test_coordinator_default_device_is_cuda():
    """The coordinator's planners (and so the coordinator) need a card
    unless told device='cpu'; nothing is left listening on failure."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    for mode in ("simulate", "analytic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ClusterCoordinator(ClusterConfig(planner_mode=mode))
    coord = ClusterCoordinator(ClusterConfig(device="cpu"))
    try:
        assert coord.device.type == "cpu"
        assert coord.planner.device == "cpu"
        assert coord.warmup_launches == {}
    finally:
        coord.shutdown()
