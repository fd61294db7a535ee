"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside
the ``cuda`` fixture).  On a machine with a card, and without JAX, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  This file
imports only ``repro_torch``.  Each kernel must equal its plain version
bit for bit (``sojourn_cells``, ``coded_cells``) or within
``1e-5 * (|coeffs| @ |blocks|)`` (``combine``), and the sweeps and the
planner must give on the card exactly what they give on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.core.coding import CodingCandidate
from repro_torch.core.order_stats import Empirical, ShiftedExponential
from repro_torch.core.policies import PolicyCandidate
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.coded import COMBINE_RTOL, combine, combine_plain
from repro_torch.kernels.sojourn_sweep import kernel as K
from repro_torch.kernels.sojourn_sweep import ops as O

pytestmark = pytest.mark.cuda

POLS = (PolicyCandidate("none"), PolicyCandidate("clone", quantile=0.85),
        PolicyCandidate("relaunch", quantile=0.9),
        PolicyCandidate("hedged", hedge_fraction=0.3))
DISTS = [ShiftedExponential(0.05, 2.0),
         Empirical(np.random.default_rng(5).gamma(2.0, 0.5, 300))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cells(seed, n_cells, n_jobs, n_g, ties, finite, dev):
    rng = np.random.default_rng(seed)
    if ties:
        grid = np.array([0.5, 1.0, 1.5, 2.0])
        arr = np.cumsum(rng.choice([0.0, 0.5, 1.0], n_jobs))
        svc = rng.choice(grid, (n_cells, n_jobs, n_g))
        alt = rng.choice(grid, (n_cells, n_jobs, n_g))
    else:
        arr = np.cumsum(rng.exponential(0.4 / max(1, n_g // 4), n_jobs))
        svc = rng.exponential(1.0, (n_cells, n_jobs, n_g)) + 0.1
        alt = rng.exponential(1.0, (n_cells, n_jobs, n_g)) + 0.1
    kinds = np.array([0, 1, 2, 3], np.int32)
    thr = np.full((n_cells, 4), np.inf)
    if finite:
        thr[:, 1] = 1.0 if ties else np.quantile(svc, 0.7)
        thr[:, 2] = 1.5 if ties else np.quantile(svc, 0.85)
    hm = np.stack([O.hedge_mask(n_jobs, f) for f in (0, 0, 0, 0.5)])
    ng = np.maximum(1, (np.arange(n_cells) + 1) * n_g // n_cells).astype(np.int32)
    f = lambda x, dt: torch.as_tensor(x).to(dev, dt).contiguous()  # noqa: E731
    return (f(arr, torch.float32), f(svc, torch.float32), f(alt, torch.float32),
            f(kinds, torch.int32), f(thr, torch.float32), f(hm, torch.bool),
            f(ng, torch.int32))


def test_kernels_build(cuda):
    secs = _build.build_all()
    assert set(secs) == set(_build.SOURCES)
    for name in _build.SOURCES:
        _build.load(name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("n_g", [1, 5, 33, 70, 300, 700])
def test_sojourn_kernel_bit_equals_plain(cuda, seed, ties, finite, n_g):
    args = _cells(seed, 3, 60, n_g, ties, finite, cuda)
    resolve = O.needs_resolve(args[3], args[4])
    before = launch_counts()["sojourn_cells"]
    out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
    assert launch_counts()["sojourn_cells"] == before + 1
    out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
    assert torch.equal(out_k, out_p)
    assert torch.equal(x_k, x_p)


def test_sojourn_kernel_resolve_false_identity(cuda):
    args = list(_cells(1, 2, 80, 9, False, False, cuda))
    a = K.sojourn_cells(*args, resolve=False)
    b = K.sojourn_cells(*args, resolve=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sojourn_kernel_fleet_width(cuda):
    """G=2000 sets (32 KB of shared state, above the 48 KB default only
    for G > 3072) at 300 jobs: bit-equal to the plain version."""
    args = _cells(4, 1, 300, 2000, False, True, cuda)
    out_k, x_k = K.sojourn_cells(*args, resolve=True)
    out_p, x_p = K.sojourn_cells_plain(*args, resolve=True)
    assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)
    args = _cells(5, 1, 50, 5000, False, True, cuda)
    out_k, _ = K.sojourn_cells(*args, resolve=True)
    out_p, _ = K.sojourn_cells_plain(*args, resolve=True)
    assert torch.equal(out_k, out_p)


def test_sojourn_kernel_rejects_too_many_groups(cuda):
    args = _cells(0, 1, 4, 20_000, False, False, cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        K.sojourn_cells(*args, resolve=False)
    args = _cells(0, 1, 4, 1, False, False, cuda)
    empty = args[1][:, :, :0].contiguous()
    with pytest.raises(ValueError, match="shared-memory"):
        K.sojourn_cells(args[0], empty, empty, *args[3:], resolve=False)


@pytest.mark.parametrize("n", [1, 2, 16, 64, 65, 1000, 10_000])
@pytest.mark.parametrize("dup", [False, True])
def test_coded_kernel_bit_equals_plain(cuda, n, dup):
    g = torch.Generator(device="cpu").manual_seed(n)
    times = torch.empty((3, 257, n)).exponential_(generator=g)
    if dup:
        times = torch.floor(times * 4) / 4
    times = times.to(cuda)
    ks = torch.tensor([1, max(1, n // 2), n], dtype=torch.int32, device=cuda)
    before = launch_counts()["coded_cells"]
    out = K.coded_cells(times, ks)
    assert launch_counts()["coded_cells"] == before + 1
    assert torch.equal(out, K.coded_cells_plain(times, ks))


@pytest.mark.parametrize("n", [1, 2, 16, 64])
def test_coded_radix_path_on_short_rows(cuda, n):
    """The long-row radix select is exact on short rows too."""
    g = torch.Generator(device="cpu").manual_seed(100 + n)
    times = torch.floor(torch.empty((2, 300, n)).exponential_(generator=g) * 4)
    times = times.to(cuda)
    ks = torch.tensor([1, n], dtype=torch.int32, device=cuda)
    out = K.coded_cells(times, ks, force_radix=True)
    assert torch.equal(out, K.coded_cells_plain(times, ks))
    assert torch.equal(out, K.coded_cells(times, ks))


@pytest.mark.parametrize("shape", [(1, 1, 1), (16, 12, 2048), (130, 70, 33),
                                   (1024, 1024, 2048)])
def test_combine_kernel_within_bound(cuda, shape):
    r, k, d = shape
    g = torch.Generator(device="cpu").manual_seed(r + k + d)
    a = torch.randn((r, k), generator=g).to(cuda)
    b = torch.randn((k, d), generator=g).to(cuda)
    before = launch_counts()["combine"]
    out = combine(a, b)
    assert launch_counts()["combine"] == before + 1
    ref = combine_plain(a, b)
    bound = COMBINE_RTOL * (a.double().abs() @ b.double().abs())
    assert bool(((out.double() - ref.double()).abs() <= bound).all())


def test_sweeps_on_card_equal_cpu(cuda):
    kw = dict(arrival_rate=4.0, n_jobs=400, seed=3, feasible_b=[2, 4, 8])
    codes = (CodingCandidate("mds", 4, encode_overhead=0.01,
                             decode_overhead=0.02),
             CodingCandidate("cyclic", 2, encode_overhead=0.0,
                             decode_overhead=0.0))
    runs = [
        lambda d: TS.sweep_simulate(DISTS, 16, n_trials=400, seed=1,
                                    device=d),
        lambda d: TS.sweep_sojourn(DISTS, 16, device=d, **kw),
        lambda d: TS.sweep_sojourn_speculative(DISTS, 16, quantiles=(None, 0.9),
                                               device=d, **kw),
        lambda d: TS.sweep_sojourn_policies(DISTS, 16, policies=POLS,
                                            device=d, **kw),
        lambda d: TS.sweep_coded(DISTS, 16, codes, n_trials=400, seed=5,
                                 device=d),
        lambda d: TS.sweep_sojourn_coded(DISTS, 16, codes, arrival_rate=0.6,
                                         n_jobs=400, seed=2, device=d),
    ]
    for run in runs:
        on_card, on_cpu = run("cuda"), run("cpu")
        assert on_card.backend == "cuda" and on_cpu.backend == "cpu"
        np.testing.assert_array_equal(on_card.samples, on_cpu.samples)


def test_default_device_plan_runs_on_card(cuda):
    spec = TP.ClusterSpec(n_workers=16, dist=DISTS[0], feasible_b=(2, 4, 8))
    obj = TP.Objective(metric="p99", utilization=0.7, policies=POLS)
    on_card = TP.SimulatedPlanner(n_trials=400).plan(spec, obj)
    on_cpu = TP.SimulatedPlanner(n_trials=400, device="cpu").plan(spec, obj)
    assert on_card.backend == "cuda"
    assert on_card.n_batches == on_cpu.n_batches
    assert on_card.policy == on_cpu.policy
    assert on_card.spectrum.points == on_cpu.spectrum.points
