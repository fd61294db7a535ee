"""The port's kernels' plain versions against the reference kernels.

* ``sojourn_cells_plain`` is bit-equal to the reference's Pallas kernel
  (``sojourn_policy_cells(backend="pallas")``, interpret mode) and to the
  numpy oracle ``ref.sojourn_cells_reference`` run on float32 inputs:
  random cells with all four policy kinds, finite and infinite thresholds,
  padded groups (``n_groups < G``), forced ties, and both settings of the
  static ``resolve`` flag.
* ``coded_cells_plain`` is bit-equal to ``coded_completion_cells(backend=
  "pallas")`` (selection is value-exact), duplicates included.
* ``combine_plain`` matches ``combine_pallas`` within
  ``1e-5 * (|coeffs| @ |blocks|)`` elementwise (the sums run in another
  order).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

from repro.kernels.coded import kernel as RC
from repro.kernels.sojourn_sweep import ops as RO
from repro.kernels.sojourn_sweep import ref as RR
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coded import COMBINE_RTOL, combine, combine_plain
from repro_torch.kernels.sojourn_sweep import kernel as TK
from repro_torch.kernels.sojourn_sweep import ops as TO

N_CELLS, N_JOBS, N_G = 3, 40, 5
KINDS = np.array([RR.KIND_NONE, RR.KIND_CLONE, RR.KIND_RELAUNCH,
                  RR.KIND_HEDGED], np.int32)


def _batch(seed: int, ties: bool, finite: bool):
    """One (cells, policies) float32 batch; ``ties`` draws every time from
    a small grid so dispatch, trigger and resolution ties all occur."""
    rng = np.random.default_rng(seed)
    if ties:
        grid = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
        arr = np.cumsum(rng.choice([0.0, 0.5, 1.0], N_JOBS)).astype(np.float32)
        svc = rng.choice(grid, (N_CELLS, N_JOBS, N_G))
        alt = rng.choice(grid, (N_CELLS, N_JOBS, N_G))
    else:
        arr = np.cumsum(rng.exponential(0.4, N_JOBS)).astype(np.float32)
        svc = (rng.exponential(1.0, (N_CELLS, N_JOBS, N_G)) + 0.1)
        alt = (rng.exponential(1.0, (N_CELLS, N_JOBS, N_G)) + 0.1)
    svc = svc.astype(np.float32)
    alt = alt.astype(np.float32)
    thr = np.full((N_CELLS, 4), np.inf, np.float32)
    if finite:
        if ties:
            thr[:, 1] = 1.0
            thr[:, 2] = 1.5
        else:
            thr[:, 1] = np.quantile(svc.astype(np.float64), 0.7, axis=(1, 2))
            thr[:, 2] = np.quantile(svc.astype(np.float64), 0.85, axis=(1, 2))
    hm = np.stack([RO.hedge_mask(N_JOBS, f) for f in (0.0, 0.0, 0.0, 0.5)])
    ng = np.array([1, 3, N_G], np.int32)  # padded groups in cells 0 and 1
    return arr, svc, alt, KINDS, thr, hm, ng


def _plain(arr, svc, alt, kinds, thr, hm, ng, resolve=None):
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
    if resolve is None:
        resolve = TO.needs_resolve(kinds, thr)
    out, x = TK.sojourn_cells(t(arr), t(svc), t(alt), t(kinds), t(thr),
                              t(hm), t(ng), resolve=resolve)
    return out.numpy(), x.numpy()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("finite", [True, False])
def test_sojourn_plain_bit_matches_pallas_and_ref(seed, ties, finite):
    batch = _batch(seed, ties, finite)
    out_t, x_t = _plain(*batch)
    out_p, x_p = RO.sojourn_policy_cells(*batch, backend="pallas")
    np.testing.assert_array_equal(out_t, np.asarray(out_p))
    np.testing.assert_array_equal(x_t, np.asarray(x_p))
    out_r, x_r = RR.sojourn_cells_reference(*batch)
    np.testing.assert_array_equal(out_t, out_r)
    np.testing.assert_array_equal(x_t, x_r)


@pytest.mark.parametrize("seed", range(3))
def test_sojourn_plain_resolve_false_is_the_identity_pass(seed):
    """Trigger-free lanes (none, hedged, clone with an inf threshold): the
    specialization resolve=False must not change a bit, and must agree
    with the reference's Pallas kernel, which takes resolve=False too."""
    arr, svc, alt, _, thr, hm, ng = _batch(seed, ties=seed == 2, finite=False)
    kinds = np.array([RR.KIND_NONE, RR.KIND_CLONE, RR.KIND_HEDGED], np.int32)
    thr = thr[:, :3]
    hm = hm[[0, 1, 3]]
    assert not TO.needs_resolve(kinds, thr)
    fast = _plain(arr, svc, alt, kinds, thr, hm, ng, resolve=False)
    full = _plain(arr, svc, alt, kinds, thr, hm, ng, resolve=True)
    for a, b in zip(fast, full):
        np.testing.assert_array_equal(a, b)
    out_p, x_p = RO.sojourn_policy_cells(arr, svc, alt, kinds, thr, hm, ng,
                                         backend="pallas")
    np.testing.assert_array_equal(fast[0], np.asarray(out_p))
    np.testing.assert_array_equal(fast[1], np.asarray(x_p))


def test_needs_resolve_matches_reference_rule():
    thr = np.array([[np.inf, 1.0]], np.float32)
    assert TO.needs_resolve(np.array([0, 1]), thr)
    assert not TO.needs_resolve(np.array([0, 3]), thr)
    assert not TO.needs_resolve(np.array([1, 2]), np.full((1, 2), np.inf))


def test_hedge_mask_and_kind_codes_equal_reference():
    for n, f in [(17, 0.0), (40, 0.3), (64, 1.0), (33, 0.77)]:
        np.testing.assert_array_equal(TO.hedge_mask(n, f), RO.hedge_mask(n, f))
    for k in ("none", "clone", "relaunch", "hedged"):
        assert TO.policy_kind_code(k) == RO.policy_kind_code(k)
    with pytest.raises(ValueError, match="unknown policy kind"):
        TO.policy_kind_code("speculate")


@pytest.mark.parametrize("n_workers,dup", [(1, False), (12, False), (12, True),
                                           (70, True)])
def test_coded_plain_bit_matches_pallas(n_workers, dup):
    rng = np.random.default_rng(n_workers)
    if dup:
        times = rng.choice(np.array([0.25, 0.5, 0.75, 1.0], np.float32),
                           (4, 32, n_workers))
    else:
        times = (rng.exponential(1.0, (4, 32, n_workers)) + 0.05)
    times = times.astype(np.float32)
    ks = rng.integers(1, n_workers + 1, 4).astype(np.int32)
    ks[0] = 1
    ks[-1] = n_workers
    out_t = TO.coded_completion_cells(torch.as_tensor(times), ks).numpy()
    out_p = RO.coded_completion_cells(times, ks, backend="pallas")
    np.testing.assert_array_equal(out_t, np.asarray(out_p))
    np.testing.assert_array_equal(
        out_t, RR.coded_completion_reference(times, ks))


def test_coded_rejects_out_of_range_quorum():
    times = torch.ones((2, 3, 4))
    with pytest.raises(ValueError, match="ks must be in"):
        TO.coded_completion_cells(times, [1, 5])


@pytest.mark.parametrize("shape", [(16, 12, 2048), (5, 7, 33), (1, 1, 1)])
def test_combine_plain_within_bound_of_pallas(shape):
    r, k, d = shape
    rng = np.random.default_rng(r * 100 + k)
    a = rng.standard_normal((r, k)).astype(np.float32)
    b = rng.standard_normal((k, d)).astype(np.float32)
    ref = np.asarray(RC.combine_pallas(a, b))
    got = combine(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    bound = COMBINE_RTOL * (np.abs(a).astype(np.float64)
                            @ np.abs(b).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - ref) <= bound)
    np.testing.assert_array_equal(
        got, combine_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy())


def test_wrappers_validate_inputs():
    f = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError, match="dtype"):
        TK.coded_cells(f.double(), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        TK.coded_cells(f, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        combine(torch.zeros((4, 3)).t(), torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="coeffs k"):
        combine(torch.zeros((2, 3)), torch.zeros((4, 2)))


def test_cpu_tensors_never_count_a_launch():
    before = launch_counts()
    _plain(*_batch(0, ties=False, finite=True))
    TO.coded_completion_cells(torch.ones((1, 2, 3)), [2])
    combine(torch.ones((2, 3)), torch.ones((3, 4)))
    assert launch_counts() == before
