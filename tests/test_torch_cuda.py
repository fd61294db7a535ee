"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside
the ``cuda`` fixture).  On a machine with a card, and without JAX, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  This file
imports only ``repro_torch`` and ``chip_smoke``'s ``replan_log`` and
``routed_to_cpu``.  Each kernel must equal its plain version
bit for bit (``sojourn_cells``, ``coded_cells``) or within
``1e-5 * (|coeffs| @ |blocks|)`` (``combine``), and the sweeps and the
planner must give on the card exactly what they give on the CPU.
``coded_cells`` is held so at every width of its short-row path, at the
largest row its radix select stages in shared memory and one above, with
``ks`` on the card and in host memory; its radix passes leave the plain
version's candidate counts, each call is one launch, and ptxas gives its
short-row kernels no stack frame and no spills.  The
attention kernels are held to their plain versions at 5e-5 in float32; in
bfloat16 flash attention at 5e-2 (``tests/test_kernels.py``'s tolerance)
and decode attention within a tenth of its plain output's RMS (its outputs
average up to a thousand value rows and are small).  The SSD scan is held
to its plain version within 1e-4 * (1 + |plain|) in float32 and
5e-2 * (1 + |plain|) in bfloat16 (y's rounding), its final state within
1e-4 * (1 + |plain|), on mild-decay inputs, also over 4,096 positions;
in bfloat16 it runs its tensor-core kernel (HMMA in its SASS), in float32
its FMA kernel, and it reads the model's strided views of one activation
bit for bit as it reads copies.  The dense and hybrid LMs' logits on the
card meet the CPU's within 4e-2.  The serving sweep and its standalone
replay give on the card exactly what they give on the CPU.  So do the
per-placement entry points (``simulate_maxmin``, ``simulate_coverage``,
the per-B sojourns, ``simulate_gradient_coding``), the rate-aware and
bootstrap planners and the tuner fed the same telemetry
(``compare_schemes``' float64 means within 1e-12 relative: the card sums
in another order).  A small tuner-on serving engine with the model makes
on the card the CPU's schedule and re-plans, through ``sojourn_cells``
and the attention kernels (and ``ssd_scan`` on the hybrid).  A 2-worker
cluster with its planners on the card serves a stream and re-plans
through ``sojourn_cells``; its workers run ``matmul`` payloads on the card.
In a one-rank NCCL group every RDP aggregation mode and collective returns
its input's mean (one card holds one rank; the semantics across ranks are
held on CPU gloo in ``tests/test_torch_replication.py``).  The training
path: ``FlashAttentionFn``'s output and gradients within the attention
tolerances of autograd through the plain version at head dims 64, 112 and
128, both dtypes, causal and not; the wrappers without a backward refuse
inputs that require grad; a reduced ``train_loss`` backward on the card
reaches every parameter (the attention projections nonzero), one flash
launch a layer, each leaf within 5e-2 of its largest CPU gradient; a
``Checkpointer`` round trip of card bf16 tensors; and the trainer on the
card keeps the CPU's simulated times and plans.  The hybrid training path:
``SsdScanFn`` on views of one activation, one launch, its output and
gradients within the scan's tolerances of autograd through the plain
version; reduced zamba2's backward reaches every parameter (one
``ssd_scan`` launch a Mamba-2 block), and its trainer keeps the CPU's
control plane.  The head-dim-128 dense configs: flash and decode at groups
of 5, 12 and 48, and the reduced models' logits against the CPU's.  The
MoE, VLM, audio and xLSTM families: flash non-causal at whisper's encoder
and cross shapes, decode at group 1 / d 128, internvl2's group 8 and
whisper's 1,500-frame cross cache; ``apply_moe`` at full width on the card
against the CPU (the same experts, outputs within 2e-2, no host sync in
the dispatch); ``mlstm_chunked`` on the card within 1e-4 of float32 on the
CPU; the reduced models (whisper through ``encode`` and its cross cache)
against the CPU's logits.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import gradient_coding as TG
from repro_torch.core import planner as TP
from repro_torch.core import simulator as TS
from repro_torch.core import tuner as TT
from repro_torch.core.coding import CodingCandidate
from repro_torch.core.order_stats import Empirical, ShiftedExponential
from repro_torch.core.policies import (
    PolicyCandidate,
    ShedPolicy,
    SloClass,
    balanced_nonoverlapping,
    overlapping_cyclic,
    rate_aware_assignment,
)
from repro_torch.kernels import _build, launch_counts
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.coded import COMBINE_RTOL, combine, combine_plain
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                params_to, prefill)
from repro_torch.kernels.sojourn_sweep import kernel as K
from repro_torch.kernels.sojourn_sweep import ops as O
from repro_torch.kernels.ssm_scan import ops as SS

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import replan_log, routed_to_cpu  # noqa: E402  (main() is not run)

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
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain versions
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
    """No replica set, or a row whose node and group tables the card's
    shared memory cannot hold (past 897,024 sets on the H100), raises and
    says why."""
    wide_max = K._max_wide_groups()
    assert wide_max >= 65_536
    args = _cells(0, 1, 4, wide_max + 1, False, False, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K.sojourn_cells(*args, resolve=False)
    args = _cells(0, 1, 4, 1, False, False, cuda)
    empty = args[1][:, :, :0].contiguous()
    with pytest.raises(ValueError, match="at least 1"):
        K.sojourn_cells(args[0], empty, empty, *args[3:], resolve=False)


# the staged limit and one past it, the last and first widths of 3 and 4
# groups of nodes, r = 1 of a 16,384-worker fleet, 65,536 sets, and the
# widest row the unstaged tables hold
WIDE_GROUPS = [11_520, 11_521, 12_288, 12_289, 16_384, 65_536]


@pytest.mark.parametrize("n_g", WIDE_GROUPS)
@pytest.mark.parametrize("ties", [False, True])
def test_sojourn_wide_kernel_bit_equals_plain(cuda, n_g, ties):
    """Two cells (n_g // 2 and n_g sets) and all four policies in one
    launch, finite and infinite thresholds, bit-equal to the plain version;
    G <= the staged limit runs the staged kernel, a wider G the unstaged
    one, each one launch."""
    assert (n_g <= K._max_groups()) == (n_g <= 11_520)
    for finite in (True, False):
        args = _cells(n_g, 2, 200, n_g, ties, finite, cuda)
        resolve = O.needs_resolve(args[3], args[4])
        before = launch_counts()["sojourn_cells"]
        out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
        assert launch_counts()["sojourn_cells"] == before + 1
        out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
        assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)


def test_sojourn_wide_kernel_mixed_groups(cuda):
    """Cells of 0, 1, 11,520, 11,521 and 16,384 sets padded to 16,384 in
    one unstaged launch, bit-equal to the plain version."""
    for ties in (False, True):
        args = list(_cells(17 + ties, 5, 200, 16_384, ties, True, cuda))
        args[6] = torch.tensor([0, 1, 11_520, 11_521, 16_384],
                               dtype=torch.int32, device=cuda)
        resolve = O.needs_resolve(args[3], args[4])
        out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
        out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
        assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)


@pytest.mark.parametrize("n_g,n_jobs,n_cells", [
    (9, 400, 3), (300, 2_000, 3), (5_000, 8_000, 3), (10_000, 12_000, 1)])
def test_sojourn_wide_kernel_equals_staged_past_the_sets(cuda, n_g, n_jobs,
                                                         n_cells):
    """The unstaged kernel at widths the staged one holds (force_wide),
    on more jobs than sets, so that every lane's table entries win the
    root, lose it and are rewritten (1 to 3 nodes a lane): bit-equal to
    the staged kernel, and at 400 jobs to the plain version; negative
    draws (the clone recompute) at 9 sets."""
    for ties in (False, True):
        args = _cells(n_g + ties, n_cells, n_jobs, n_g, ties, True, cuda)
        if n_g == 9:
            args = (args[0], args[1] - 0.9, args[2] - 0.9, *args[3:])
        resolve = O.needs_resolve(args[3], args[4])
        wide = K.sojourn_cells(*args, resolve=resolve, force_wide=True)
        staged = K.sojourn_cells(*args, resolve=resolve)
        assert torch.equal(wide[0], staged[0])
        assert torch.equal(wide[1], staged[1])
        if n_jobs <= 400:
            plain = K.sojourn_cells_plain(*args, resolve=resolve)
            assert torch.equal(wide[0], plain[0])
            assert torch.equal(wide[1], plain[1])


def test_sojourn_wide_kernel_at_its_widest_row(cuda):
    """The widest row the tables hold (219 groups, seven entries a lane, on
    the H100: a dynamic shared-memory request past the 48 KB default, no
    set staged), bit-equal to the plain version."""
    n_g = K._max_wide_groups()
    assert K._wide_split(n_g) == (0, 0)
    args = _cells(3, 1, 40, n_g, False, True, cuda)
    resolve = O.needs_resolve(args[3], args[4])
    out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
    out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
    assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)


def test_sojourn_wide_split_fills_shared_memory(cuda):
    """The unstaged split on the H100: every set's hot words and the first
    4,352 sets' cold ones at 16,384 sets (nodes in registers), the first
    17,792 sets' hot words at 65,536 (beside the tables); none past the
    widest row's tables."""
    if K._max_groups() != 11_520:
        pytest.skip("the figures are the H100's")
    assert K._wide_split(16_384) == (16_384, 4_352)
    assert K._wide_split(65_536) == (17_792, 0)
    assert K._max_wide_groups() == 897_024


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_sojourn_wide_kernel_around_the_split(cuda, offset):
    """Cells of 9 and K + offset sets (K the split at 65,536) padded to
    65,536, one launch, bit-equal to the plain version, with and without
    ties."""
    kh, _ = K._wide_split(65_536)
    for ties in (False, True):
        args = _cells(kh + offset + ties, 2, 120, 65_536, ties, True, cuda)
        args[6].copy_(torch.tensor([9, kh + offset], dtype=torch.int32))
        resolve = O.needs_resolve(args[3], args[4])
        out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
        out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
        assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)


def test_sojourn_wide_tables_past_the_sets(cuda):
    """The node and group tables (past 16,384 sets: 17,000 sets, five
    groups) on more jobs than sets, so that every group's entries win the
    root, lose it and are rewritten, and two changed nodes fall in two
    groups: bit-equal to the plain version at the kernel's split, and to
    that at splits with sets on both sides of others and with none on
    chip."""
    args = _cells(17_000, 1, 17_500, 17_000, False, True, cuda)
    resolve = O.needs_resolve(args[3], args[4])
    got = K.sojourn_cells(*args, resolve=resolve)
    want = K.sojourn_cells_plain(*args, resolve=resolve)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for split in ((2_048, 1_024), (0, 0)):
        other = _wide_launch(args, resolve, *split)
        assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1])


def _wide_launch(args, resolve, kh, kc):
    """The unstaged kernel through its C interface at split (kh, kc)."""
    import ctypes

    lib = _build.load("sojourn_cells")
    n_cells, n_jobs, n_g = args[1].shape
    n_pol = args[3].shape[0]
    out = torch.empty((n_cells, n_pol, n_jobs), device=args[1].device)
    extra = torch.empty((n_cells, n_pol), dtype=torch.int32,
                        device=args[1].device)
    state = torch.empty(max(1, n_cells * n_pol * lib.sojourn_cells_state_words(
        n_g, kh, kc)), device=args[1].device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        *args[:5], args[5].view(torch.uint8), args[6], out, extra, state)]
    code = lib.sojourn_cells_wide_launch(
        *ptrs, n_cells, n_pol, n_jobs, n_g, int(resolve), kh, kc,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, code, "sojourn_cells_wide_launch")
    return out, extra


@pytest.mark.parametrize("kc", [0, 128, 640, 1_024])
@pytest.mark.parametrize("n_g,n_jobs", [(1_000, 1_500), (9_000, 10_000)])
def test_sojourn_wide_kernel_across_the_split(cuda, n_g, n_jobs, kc):
    """The nodes in registers (up to 16,384 sets) keep every set's hot
    words on chip and split the cold ones (aux, job id) at kc: on more
    jobs than sets, so that sets on both sides are picked, fire and are
    rewritten, over one and three groups of nodes, bit-equal to the
    staged kernel.  A split that is not whole nodes, or that leaves hot
    words of these widths in the scratch, is refused."""
    gp = -(-n_g // 128) * 128
    for ties in (False, True):
        args = _cells(n_g + kc + ties, 2, n_jobs, n_g, ties, True, cuda)
        resolve = O.needs_resolve(args[3], args[4])
        out_w, x_w = _wide_launch(args, resolve, gp, kc)
        out_s, x_s = K.sojourn_cells(*args, resolve=resolve)
        assert torch.equal(out_w, out_s) and torch.equal(x_w, x_s)
    for bad in ((gp, 100), (0, 0)):
        with pytest.raises(RuntimeError, match="wide_launch"):
            _wide_launch(args, resolve, *bad)


# every width of the short-row path (W = 1, 2, 4, 8, 16, 32 lanes a row,
# two values a lane up to 64) at and beside its edges, the switch to the
# radix select at 64/65, and long rows
CODED_N = [1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 31, 32, 33, 48, 63, 64,
           65, 1000, 10_000]


def _coded_times(n, dup, seed=None, rows=257):
    g = torch.Generator(device="cpu").manual_seed(n if seed is None else seed)
    times = torch.empty((3, rows, n)).exponential_(generator=g)
    if dup:
        times = torch.floor(times * 4) / 4
    return times


@pytest.mark.parametrize("n", CODED_N)
@pytest.mark.parametrize("dup", [False, True])
def test_coded_kernel_bit_equals_plain(cuda, n, dup):
    times = _coded_times(n, dup).to(cuda)
    ks = torch.tensor([1, max(1, n // 2), n], dtype=torch.int32, device=cuda)
    before = launch_counts()["coded_cells"]
    out = K.coded_cells(times, ks)
    assert launch_counts()["coded_cells"] == before + 1
    assert torch.equal(out, K.coded_cells_plain(times, ks))
    # the same quorums from host memory, carried by value in the launch
    assert torch.equal(K.coded_cells(times, ks.cpu()), out)


def test_coded_kernel_staged_row_limit(cuda):
    """The largest row the radix select stages in shared memory, and one
    more, which runs its passes over device memory."""
    lib = _build.load("coded_cells")
    top = lib.coded_cells_max_staged_n()
    assert 50_000 <= top < 60_000
    for n in (top, top + 1):
        for dup in (False, True):
            times = _coded_times(n, dup, rows=9).to(cuda)
            ks = torch.tensor([1, n // 3, n], dtype=torch.int32, device=cuda)
            out = K.coded_cells(times, ks)
            assert torch.equal(out, K.coded_cells_plain(times, ks))


def test_coded_kernel_one_launch_per_call(cuda):
    """Each wrapper call is one launch, on every path: short rows, the radix
    select (forced, long rows, recording its pass counts), ks on the card or
    by value; the seam adds none."""
    for n, force in ((16, False), (16, True), (64, False), (65, False),
                     (3000, False)):
        times = _coded_times(n, False, rows=50).to(cuda)
        for ks in (torch.tensor([1, n, max(1, n - 3)], dtype=torch.int32),
                   torch.tensor([2, 1, n], dtype=torch.int32, device=cuda)):
            before = launch_counts()["coded_cells"]
            K.coded_cells(times, ks, force_radix=force)
            assert launch_counts()["coded_cells"] == before + 1
            K.coded_radix_counts(times, ks)
            assert launch_counts()["coded_cells"] == before + 2
            O.coded_completion_cells(times, ks.cpu().numpy())
            assert launch_counts()["coded_cells"] == before + 3


@pytest.mark.parametrize("n", [16, 65, 1000, 10_000])
@pytest.mark.parametrize("dup", [False, True])
def test_coded_radix_counts_match_plain(cuda, n, dup):
    """The passes the kernel runs are the plain version's: the same
    candidates after every pass, row by row, and the same values."""
    times = _coded_times(n, dup, rows=64).to(cuda)
    ks = torch.tensor([1, max(1, n // 2), max(1, n - n // 10)],
                      dtype=torch.int32, device=cuda)
    out, counts = K.coded_radix_counts(times, ks)
    assert torch.equal(out, K.coded_cells_plain(times, ks))
    assert torch.equal(counts, K.coded_radix_counts_plain(times, ks))


def test_coded_kernel_constants_and_build_log(cuda):
    """The wrapper's constants are the source's, and the short-row kernels
    keep nothing in local memory (ptxas: 0 bytes stack frame, no spills)."""
    lib = _build.load("coded_cells")
    assert lib.coded_cells_host_quorums() == K.CODED_HOST_QUORUMS
    assert lib.coded_cells_max_passes() == K.CODED_MAX_PASSES
    log = _build._lib_path("coded_cells").with_suffix(".log").read_text()
    frames = _build.stack_frames(log)
    short = {f: b for f, b in frames.items() if "coded_warp_kernel" in f}
    assert len(short) == 7, sorted(frames)
    assert all(b == (0, 0, 0) for b in short.values()), short


def test_coded_host_quorums_rejected_past_limit(cuda):
    times = torch.ones((K.CODED_HOST_QUORUMS + 1, 2, 3), device=cuda)
    ks = torch.ones(K.CODED_HOST_QUORUMS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="host memory"):
        K.coded_cells(times, ks)
    assert torch.equal(K.coded_cells(times, ks.to(cuda)),
                       torch.ones((K.CODED_HOST_QUORUMS + 1, 2), device=cuda))


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


@pytest.mark.parametrize("n_g", [1, 2, 31, 32, 33, 64, 257, 2000, 6000,
                                 10_000])
@pytest.mark.parametrize("ties", [False, True])
def test_sojourn_tree_kernel_mixed_groups_one_launch(cuda, n_g, ties):
    """Three cells of mixed n_groups and all four policies in one launch,
    bit-equal to the plain version at the tree's edges (one level up to
    128 sets, two above), past one node a lane (6,000 sets: the
    three-node build with programs of one and two) and at 10,000 sets;
    resolve=False equals resolve=True when no policy can arm a trigger."""
    n_jobs = 30 if n_g > 2000 else 80
    for finite in (True, False):
        args = _cells(n_g, 3, n_jobs, n_g, ties, finite, cuda)
        resolve = O.needs_resolve(args[3], args[4])
        before = launch_counts()["sojourn_cells"]
        out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
        assert launch_counts()["sojourn_cells"] == before + 1
        out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
        assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)
        if not finite:
            on = K.sojourn_cells(*args, resolve=True)
            assert torch.equal(on[0], out_k) and torch.equal(on[1], x_k)


def test_sojourn_kernel_cell_without_sets(cuda):
    """A cell of no replica set in the launch: every job starts at inf, as
    the plain version computes it."""
    args = list(_cells(3, 2, 40, 5, False, True, cuda))
    args[6] = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    resolve = O.needs_resolve(args[3], args[4])
    out_k, x_k = K.sojourn_cells(*args, resolve=resolve)
    out_p, x_p = K.sojourn_cells_plain(*args, resolve=resolve)
    assert torch.equal(out_k, out_p) and torch.equal(x_k, x_p)


def test_sojourn_kernel_holds_the_sweep_benchmarks_width(cuda):
    assert K._max_groups() >= 10_000


def test_policy_sweep_is_one_launch_on_card(cuda):
    kw = dict(arrival_rate=4.0, n_jobs=400, seed=3, feasible_b=[2, 4, 8])
    before = launch_counts()["sojourn_cells"]
    on_card = TS.sweep_sojourn_policies(DISTS, 16, policies=POLS,
                                        device="cuda", **kw)
    assert launch_counts()["sojourn_cells"] == before + 1
    on_cpu = TS.sweep_sojourn_policies(DISTS, 16, policies=POLS,
                                       device="cpu", **kw)
    np.testing.assert_array_equal(on_card.samples, on_cpu.samples)
    np.testing.assert_array_equal(on_card.extra_fraction,
                                  on_cpu.extra_fraction)


@pytest.mark.parametrize("r", [1, 16, 17, 33, 1024])
@pytest.mark.parametrize("k", [1, 12, 13, 1024])
@pytest.mark.parametrize("d", [2048, 1001])
def test_combine_paths_within_bound(cuda, r, k, d):
    """The small-R strip kernel (R <= 32 and R x K <= 12,288) and the tiled
    kernel, at ragged R, K and D (D = 1001 takes the scalar loads)."""
    g = torch.Generator(device="cpu").manual_seed(7 * r + k + d)
    a = torch.randn((r, k), generator=g).to(cuda)
    b = torch.randn((k, d), generator=g).to(cuda)
    out = combine(a, b)
    ref = combine_plain(a, b)
    bound = COMBINE_RTOL * (a.double().abs() @ b.double().abs())
    assert bool(((out.double() - ref.double()).abs() <= bound).all())
    path = _build.load("combine").combine_path(r, k)
    assert path == (0 if r <= 32 and r * k <= 12_288 else 1)


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


def test_per_placement_entries_on_card_equal_cpu(cuda):
    rates = np.random.default_rng(0).uniform(0.2, 3.0, 96)
    for a in (balanced_nonoverlapping(8, 4), overlapping_cyclic(16, 4),
              rate_aware_assignment(12, 3, rates[:12]),
              balanced_nonoverlapping(96, 8)):
        for dist in DISTS:
            for r in (None, rates[:a.n_workers]):
                on = [TS.simulate_coverage(dist, a, n_trials=500, seed=7,
                                           rates=r, device=d).samples
                      for d in ("cuda", "cpu")]
                np.testing.assert_array_equal(*on)
    for dist in DISTS:
        on = [TS.simulate_maxmin(dist, 12, 4, n_trials=500, seed=2,
                                 rates=rates[:12], device=d).samples
              for d in ("cuda", "cpu")]
        np.testing.assert_array_equal(*on)
        on = [TG.simulate_gradient_coding(dist, 16, 5, n_trials=500, seed=3,
                                          device=d).samples
              for d in ("cuda", "cpu")]
        np.testing.assert_array_equal(*on)
        wb = rate_aware_assignment(12, 4, rates[:12]).worker_batch
        for kw in (dict(), dict(rates=rates[:12], worker_batch=wb)):
            on = [TS.simulate_sojourn_policies(
                dist, 12, 4, 2.0, POLS, n_jobs=300, seed=3, device=d, **kw)
                for d in ("cuda", "cpu")]
            for x, y in zip(*on):
                np.testing.assert_array_equal(x, y)
            on = [TS.simulate_sojourn_quantiles(
                dist, 12, 4, 2.0, (None, 0.9), n_jobs=300, seed=3, device=d,
                **kw) for d in ("cuda", "cpu")]
            for x, y in zip(*on):
                np.testing.assert_array_equal(x, y)
    card, host = (TG.compare_schemes(DISTS[0], 12, n_trials=500, device=d)
                  for d in ("cuda", "cpu"))
    for part in ("replication", "coding"):
        for k, v in host[part].items():
            assert card[part][k] == pytest.approx(v, rel=1e-12, abs=0.0)


_SKEWED = TP.ClusterSpec(n_workers=12, dist=DISTS[0],
                         rates=tuple(np.linspace(0.3, 1.7, 12)))
_POOL = TP.ClusterSpec(n_workers=12, dist=Empirical(
    np.random.default_rng(3).lognormal(-1.0, 0.8, 600)))
_CODES = tuple(CodingCandidate("mds", s, encode_overhead=0.002,
                               decode_overhead=0.003) for s in (2, 4))


@pytest.mark.parametrize("planner,spec,obj", [
    ("heterogeneous", _SKEWED, TP.Objective(metric="mean")),
    ("heterogeneous", _SKEWED, TP.Objective(metric="p99", utilization=0.6,
                                            policies=POLS)),
    ("heterogeneous", _SKEWED, TP.Objective(
        metric="p99", utilization=0.6, speculation_quantiles=(0.8, 0.9))),
    ("empirical", _POOL, TP.Objective(metric="mean", coding=_CODES)),
    ("empirical", _POOL, TP.Objective(metric="p99", utilization=0.7,
                                      policies=POLS, coding=_CODES)),
    ("empirical", _SKEWED, TP.Objective(metric="p99", utilization=0.6,
                                        policies=POLS)),
])
def test_new_planners_on_card_equal_cpu(cuda, planner, spec, obj):
    mode = "empirical" if planner == "empirical" else "simulate"
    plans = [TP.make_planner(mode, heterogeneous=True, n_trials=300,
                             n_resamples=4, device=d).plan(spec, obj)
             for d in ("cuda", "cpu")]
    card, host = plans
    assert (card.backend, host.backend) == ("cuda", "cpu")
    for f in ("n_batches", "policy", "speculation_quantile", "coding",
              "confidence", "vote_share", "closed_form_mean"):
        assert getattr(card, f) == getattr(host, f), f
    assert card.spectrum.points == host.spectrum.points


def test_tuner_on_card_equals_cpu(cuda):
    sim = TS.StepTimeSimulator(DISTS[0], 12, seed=0, slow_workers={0: 4.0})
    steps = [sim.next_step() for _ in range(12)]
    tuners = {d: TT.StragglerTuner(
        TT.ReplicationPlan(12, 4),
        TT.TunerConfig(mode="simulate", heterogeneous=True, sim_trials=200,
                       cooldown_steps=2, metric="p99", gof_alpha=0.01,
                       bootstrap_resamples=3, device=d),
        policy_candidates=POLS[1:]) for d in ("cuda", "cpu")}
    for t in steps:
        moves = []
        for tuner in tuners.values():
            tuner.observe(t)
            tuner.observe_load(10.0)
            rp = tuner.maybe_replan()
            moves.append(None if rp is None else (
                rp.step, rp.old_batches, rp.new_batches, rp.predicted_old,
                rp.predicted_new))
            if rp is not None:
                tuner.apply(rp)
        assert moves[0] == moves[1]
        a, b = (tuner.last_plan for tuner in tuners.values())
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.planner, a.n_batches, a.policy) == (
                b.planner, b.n_batches, b.policy)
            assert a.spectrum.points == b.spectrum.points


@pytest.mark.parametrize("policies", [
    (PolicyCandidate(), PolicyCandidate("hedged", hedge_fraction=1.0)),
    POLS,
], ids=["none_hedged", "four"])
def test_serving_sweep_on_card_equals_cpu(cuda, policies):
    """The serving sweep's cells and the standalone replay on the card
    equal the CPU's bit for bit; one launch a (max_wait, shed) combo, and
    one a (max_wait, split) under cap."""
    classes = (SloClass("premium", share=0.3, weight=4.0, deadline=0.8,
                        miss_target=0.05), SloClass("batch", share=0.7))
    kw = dict(n_workers=8, request_rate=30.0, batch_size=4,
              slo_classes=classes, policies=policies,
              max_waits=(0.3, float("inf")),
              sheds=(ShedPolicy(), ShedPolicy("cap", cap=24),
                     ShedPolicy("expired")),
              n_requests=1200, seed=7, feasible_b=(2, 4, 8), job_load=0.5)
    before = launch_counts()["sojourn_cells"]
    on_card = TS.sweep_sojourn_serving(DISTS[0], device="cuda", **kw)
    assert launch_counts()["sojourn_cells"] == before + 2 * 2 + 2 * 3
    on_cpu = TS.sweep_sojourn_serving(DISTS[0], device="cpu", **kw)
    assert on_card.backend == "cuda"
    np.testing.assert_array_equal(on_card.req_job, on_cpu.req_job)
    np.testing.assert_array_equal(on_card.extra_fraction,
                                  on_cpu.extra_fraction)
    for si in range(3):
        for wi in range(2):
            for hi in range(3):
                np.testing.assert_array_equal(on_card.samples[0][si][wi][hi],
                                              on_cpu.samples[0][si][wi][hi])
    sim = TS.simulate_sojourn_serving(
        DISTS[0], 8, 4, kw["request_rate"], 4, classes, policies[-1],
        max_wait=0.3, shed=ShedPolicy("cap", cap=24), n_requests=1200,
        seed=7, job_load=0.5, device="cuda")
    np.testing.assert_array_equal(
        sim.latency, on_cpu.request_latency(0, 1, len(policies) - 1, 0, 1))


ATT_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5),
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
DECODE_BF16_RMS_FRAC = 0.1


def _randn(shape, seed, dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,off", [
    (1, 128, 128, 4, 2, 64, True, 0),
    (2, 1, 37, 7, 1, 64, True, 36),
    (2, 50, 50, 4, 4, 64, True, 0),
    (1, 33, 97, 6, 2, 128, True, 64),
    (2, 40, 72, 4, 2, 128, False, 0),
    (1, 200, 330, 14, 2, 64, True, 130),
    (1, 64, 64, 2, 2, 64, True, 1000),
    (2, 256, 256, 14, 2, 64, True, 0),
    (1, 130, 130, 32, 32, 112, True, 0),   # zamba2's shared attention
    (2, 70, 70, 8, 2, 112, True, 0),
    (1, 33, 97, 4, 4, 112, True, 64),
    (2, 40, 72, 4, 2, 112, False, 0),
    # the Hopper kernel's 64-row query and 64-key tiles: ragged sq and skv,
    # sq < skv with q_offset, GQA group 7, d = 112 and 128 with and
    # without the causal mask
    (2, 100, 300, 4, 2, 64, True, 200),
    (1, 77, 190, 8, 2, 112, True, 113),
    (2, 129, 129, 7, 1, 64, True, 0),
    (1, 65, 200, 14, 2, 64, False, 0),
    (2, 192, 192, 4, 2, 128, True, 0),
    (1, 100, 140, 4, 4, 128, False, 0),
    (2, 96, 200, 4, 2, 112, False, 0),
    (1, 257, 257, 8, 8, 112, True, 0),
])
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, skv, h, kv, d,
                                    causal, off):
    q = _randn((b, sq, h, d), 1, cuda, dtype)
    k = _randn((b, skv, kv, d), 2, cuda, dtype)
    v = _randn((b, skv, kv, d), 3, cuda, dtype)
    before = launch_counts()["flash_attention"]
    out = FA.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = FA.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    torch.testing.assert_close(out.float(), ref.float(), **ATT_TOL[dtype])


@pytest.mark.parametrize("b,s,h,kv,d", [(8, 1024, 14, 2, 64),     # qwen2-0.5b
                                        (8, 1024, 32, 32, 112)])  # zamba2-7b
def test_flash_kernel_at_serve_shapes(cuda, b, s, h, kv, d):
    """The serving prefills' attention at full size, in bfloat16."""
    q = _randn((b, s, h, d), 7, cuda, torch.bfloat16)
    k = _randn((b, s, kv, d), 8, cuda, torch.bfloat16)
    v = _randn((b, s, kv, d), 9, cuda, torch.bfloat16)
    out = FA.flash_attention(q, k, v, causal=True)
    ref = FA.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(),
                               **ATT_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,d,smax,cache_len", [
    (2, 4, 2, 64, 1024, 1), (2, 4, 2, 64, 1024, 100),
    (2, 4, 2, 64, 1024, 1024), (8, 14, 2, 64, 2048, 1056),
    (2, 8, 1, 128, 300, 129), (1, 48, 1, 128, 100, 65), (3, 4, 4, 64, 65, 65),
    (2, 32, 32, 112, 2048, 1039), (2, 32, 8, 112, 300, 37),
    (1, 4, 4, 112, 100, 1), (1, 4, 2, 112, 73, 73),
    # on split boundaries of split_plan (cache_len a multiple of the split
    # length) and a cache length of 1 at S_max 2048
    (8, 14, 2, 64, 2048, 1120), (2, 4, 2, 64, 1024, 1024),
    (2, 4, 2, 64, 2048, 2048), (8, 32, 32, 112, 2048, 1040),
    (1, 8, 4, 112, 400, 336), (2, 8, 4, 128, 512, 384),
    (8, 14, 2, 64, 2048, 1),
])
def test_decode_kernel_matches_plain(cuda, dtype, b, h, kv, d, smax,
                                     cache_len):
    q = _randn((b, h, d), 4, cuda, dtype)
    kc = _randn((b, smax, kv, d), 5, cuda, dtype)
    vc = _randn((b, smax, kv, d), 6, cuda, dtype)
    before = launch_counts()["decode_attention"]
    out = DA.decode_attention(q, kc, vc, cache_len)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    ref = DA.decode_attention_plain(q, kc, vc, cache_len)
    if dtype == torch.bfloat16:
        rms = ref.float().square().mean().sqrt().item()
        tol = dict(atol=DECODE_BF16_RMS_FRAC * rms, rtol=0.0)
    else:
        tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # the kernel reads nothing at or past cache_len
    kc[:, cache_len:] = float("nan")
    vc[:, cache_len:] = float("nan")
    again = DA.decode_attention(q, kc, vc, cache_len)
    assert torch.equal(again, out)


def test_dense_lm_on_card_matches_cpu(cuda):
    cfg = reduced_config(get_config("qwen2-0.5b"))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    (lh, sh), (lc, sc) = (prefill(cfg, p, {"tokens": toks}, 80)
                          for p in (host, card))
    before = launch_counts()
    for i in range(4):
        torch.testing.assert_close(lc.float().cpu(), lh.float(), atol=4e-2,
                                   rtol=0)
        tok = lh[:, -1].argmax(-1, keepdim=True)
        lh, sh = decode_step(cfg, host, sh, tok, 70 + i)
        lc, sc = decode_step(cfg, card, sc, tok.to(cuda), 70 + i)
    after = launch_counts()
    assert after["decode_attention"] - before["decode_attention"] == (
        4 * cfg.n_layers)


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _ssd_inputs(seed, b, s, h, p, g, n, dtype, dev, init=False,
                strong=False):
    """Mild-decay inputs (dt in [0.01, 0.1]); ``strong``: dt = 30, where
    exp(cum_t - cum_s) above the diagonal overflows float32."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    dt = (torch.full((b, s, h), 30.0) if strong
          else 0.01 + 0.09 * torch.rand((b, s, h), generator=gen))
    out = [r(b, s, h, p).to(dev, dtype), dt.to(dev), (0.5 * r(h)).to(dev),
           (0.3 * r(b, s, g, n)).to(dev, dtype),
           (0.3 * r(b, s, g, n)).to(dev, dtype), (1 + 0.2 * r(h)).to(dev)]
    out.append((0.5 * r(b, h, n, p)).to(dev) if init else None)
    return out


def _ssd_close(out, ref, tol):
    ref = ref.float()
    assert bool(((out.float() - ref).abs() <= tol * (1 + ref.abs())).all()), (
        (out.float() - ref).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g", [
    (2, 1, 4, 1), (1, 37, 4, 4), (2, 64, 3, 1), (1, 200, 4, 2),
    (2, 1000, 2, 1),
])
@pytest.mark.parametrize("p,n", [(32, 16), (64, 64), (128, 16), (32, 64),
                                 (128, 64), (64, 16), (48, 80)])
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, h, g, p, n):
    args = _ssd_inputs(b * s + p + n, b, s, h, p, g, n, dtype, cuda,
                       init=(s % 2 == 1))
    before = launch_counts()["ssd_scan"]
    y, st = SS.ssd_scan(*args)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == before + 1
    assert y.dtype == dtype and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, n, p)
    yp, sp = SS.ssd_scan_plain(*args)
    _ssd_close(y, yp, SSD_TOL[dtype])
    _ssd_close(st, sp, 1e-4)


def test_ssd_kernel_at_zamba_prefill_shape(cuda):
    """b 2 of zamba2-7b's prefill: s 1024, 112 heads, P = N = 64, G = 1."""
    args = _ssd_inputs(9, 2, 1024, 112, 64, 1, 64, torch.bfloat16, cuda)
    y, st = SS.ssd_scan(*args)
    yp, sp = SS.ssd_scan_plain(*args)
    _ssd_close(y, yp, SSD_TOL[torch.bfloat16])
    _ssd_close(st, sp, 1e-4)


@pytest.mark.parametrize("s", [40, 130])
def test_ssd_kernel_strong_decay_is_finite(cuda, s):
    args = _ssd_inputs(3, 1, s, 2, 32, 1, 16, torch.float32, cuda, strong=True)
    y, st = SS.ssd_scan(*args)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yq, sq = SS.ssd_sequential(*args[:6])
    _ssd_close(y, yq, 1e-4)
    _ssd_close(st, sq, 1e-4)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    args = _ssd_inputs(0, 1, 8, 2, 32, 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim P"):
        SS.ssd_scan(torch.zeros((1, 8, 2, 136), device=cuda), *args[1:6])
    with pytest.raises(ValueError, match="is on"):
        SS.ssd_scan(args[0], args[1].cpu(), *args[2:6])


def test_hybrid_lm_on_card_matches_cpu(cuda):
    cfg = reduced_config(get_config("zamba2-7b"))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    before = launch_counts()
    (lh, sh), (lc, sc) = (prefill(cfg, p, {"tokens": toks}, 80)
                          for p in (host, card))
    assert launch_counts()["ssd_scan"] - before["ssd_scan"] == cfg.n_layers
    for i in range(4):
        torch.testing.assert_close(lc.float().cpu(), lh.float(), atol=4e-2,
                                   rtol=0)
        tok = lh[:, -1].argmax(-1, keepdim=True)
        lh, sh = decode_step(cfg, host, sh, tok, 70 + i)
        lc, sc = decode_step(cfg, card, sc, tok.to(cuda), 70 + i)
    for name in ("seg_ssm", "seg_conv"):
        torch.testing.assert_close(sc[name].float().cpu(), sh[name].float(),
                                   atol=5e-2, rtol=5e-2)


def test_ssd_bf16_long_sequence_state_drift(cuda):
    """4,096 positions (64 kernel chunks) from an initial state: the bf16
    kernel's state, carried through bf16 copies for C S and a split update,
    stays within 1e-4 (1 + |plain|) of the float32 plain version."""
    args = _ssd_inputs(17, 1, 4096, 4, 64, 1, 64, torch.bfloat16, cuda,
                       init=True)
    y, st = SS.ssd_scan(*args)
    yp, sp = SS.ssd_scan_plain(*args)
    _ssd_close(y, yp, SSD_TOL[torch.bfloat16])
    _ssd_close(st, sp, 1e-4)


def _ssd_kernel_names(args):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    SS.ssd_scan(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):  # the profiler can miss a window's first launch
            SS.ssd_scan(*args)
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "ssd" in e.name}


def test_ssd_dtype_picks_its_kernel(cuda):
    """bf16 launches the tensor-core kernel, float32 the FMA kernel."""
    mma, fma = "ssd_mma_kernel", "ssd_kernel<"
    for dtype, want, other in ((torch.bfloat16, mma, fma),
                               (torch.float32, fma, mma)):
        names = _ssd_kernel_names(
            _ssd_inputs(5, 2, 130, 4, 64, 1, 64, dtype, cuda))
        assert any(want in n for n in names), names
        assert not any(other in n for n in names), names


def test_ssd_bf16_kernel_sass_holds_hmma(cuda):
    """The bf16 kernel's SASS runs its products as HMMA; the float32
    kernel's has none."""
    import subprocess
    from pathlib import Path

    _build.load("ssd_scan")
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass",
                           str(_build._lib_path("ssd_scan"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    mma = {k: v for k, v in counts.items() if "ssd_mma_kernel" in k}
    fma = {k: v for k, v in counts.items() if "ssd_kernel" in k}
    assert len(mma) == 4 and all(v > 0 for v in mma.values()), counts
    assert fma and not any(fma.values()), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,p,g,n", [(200, 4, 64, 1, 64),
                                       (70, 6, 32, 2, 16)])
def test_ssd_strided_views_equal_copies(cuda, dtype, s, h, p, g, n):
    """x, b and c as the model passes them, slices of one (B, S, conv)
    activation, give bit for bit what contiguous copies give."""
    bsz, d_in = 2, h * p
    gen = torch.Generator(device="cpu").manual_seed(s + p)
    xbc = torch.randn((bsz, s, d_in + 2 * g * n + 8), generator=gen).to(
        cuda, dtype)
    xbc[..., d_in:] *= 0.3
    xs = xbc[..., :d_in].reshape(bsz, s, h, p)
    b = xbc[..., d_in:d_in + g * n].reshape(bsz, s, g, n)
    c = xbc[..., d_in + g * n:d_in + 2 * g * n].reshape(bsz, s, g, n)
    assert not xs.is_contiguous() and not b.is_contiguous()
    rest = _ssd_inputs(s, bsz, s, h, p, g, n, dtype, cuda, init=True)
    dt, a_log, d_skip, init = rest[1], rest[2], rest[5], rest[6]
    y_v, st_v = SS.ssd_scan(xs, dt, a_log, b, c, d_skip, init)
    y_c, st_c = SS.ssd_scan(xs.contiguous(), dt, a_log, b.contiguous(),
                            c.contiguous(), d_skip, init)
    assert torch.equal(y_v, y_c) and torch.equal(st_v, st_c)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_serving_engine_on_card_matches_cpu(cuda, arch, monkeypatch):
    """A small tuner-on engine with the model: on the card its schedule,
    re-plans and decisions are the CPU engine's (the schedule does not
    depend on the model), every request gets its tokens, and the card ran
    ``sojourn_cells`` for the re-plans and the attention kernels (and, on
    the hybrid, ``ssd_scan``) for the model."""
    import dataclasses

    from repro_torch.serving import ReplicatedServingEngine, ServeEngineConfig
    from repro_torch.serving import engine as E

    make = E.make_planner
    monkeypatch.setattr(E, "make_planner",
                        lambda *a, **kw: make(*a, **{**kw, "n_trials": 500}))
    sc = ServeEngineConfig(
        arch=arch, n_server_groups=8, n_batches=4, batch_size=4,
        prompt_len=8, gen_tokens=3, max_len=16, delta=0.02, mu=2.0,
        utilization=0.7, tuner=True, planner_mode="simulate", metric="p99",
        policy_candidates=POLS, seed=0)

    def run(device, execute_model):
        eng = ReplicatedServingEngine(dataclasses.replace(
            sc, device=device, execute_model=execute_model))
        log = replan_log(eng)
        out = eng.run_load(320)
        return eng, out, [(step, plan.n_batches, plan.policy, rp is not None)
                          for step, _, plan, rp in log]

    _build.reset_launch_counts()
    card, out_c, log_c = run("cuda", True)
    counts = launch_counts()
    _, out_h, log_h = run("cpu", False)
    assert log_c == log_h and log_c
    assert [(s.request_id, s.arrival, s.dispatched, s.completion)
            for s in out_c["stats"]] == [
        (s.request_id, s.arrival, s.dispatched, s.completion)
        for s in out_h["stats"]]
    assert (out_c["final_B"], out_c["policy"]) == (out_h["final_B"],
                                                   out_h["policy"])
    assert all(s.tokens.shape == (3,) for s in out_c["stats"])
    assert counts["sojourn_cells"] == len(log_c)
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    if arch == "zamba2-7b":
        assert counts["ssd_scan"] > 0


def test_cluster_plans_on_the_card(cuda):
    """Two worker processes; the coordinator's simulate planner and the
    tuner's load-aware re-plans launch sojourn_cells on the card."""
    from repro_torch.cluster import (ChaosInjector, ClusterConfig,
                                     LocalCluster, drive, make_sleep_spec,
                                     reap_orphans)
    from repro_torch.serving.queueing import Request

    cfg = ClusterConfig(n_workers=2, batch_size=1, max_wait=0.01,
                        payload=make_sleep_spec("exp", work=1.0, mu=50.0),
                        tuner=True, min_samples=16, cooldown=4, metric="p99",
                        seed=2, device="cuda")
    _build.reset_launch_counts()
    try:
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            base = coord.now()
            for i in range(48):
                coord.submit(Request(request_id=i,
                                     arrival=base + (i + 1) * 0.01))
            drive(cluster, ChaosInjector(cluster, []), timeout=60.0)
            s = coord.summary()
            attempted = coord.tuner._last_attempt
    finally:
        reap_orphans()
    assert s["served"] == 48 and s["deaths"] == 0
    assert coord.warmup_launches["sojourn_cells"] >= 1
    assert coord.tuner.last_plan is not None
    assert coord.tuner.last_plan.backend == "cuda"
    assert attempted >= 0  # the tuner attempted a re-plan
    assert launch_counts()["sojourn_cells"] > coord.warmup_launches[
        "sojourn_cells"]


def test_cluster_matmul_workers_run_on_the_card(cuda):
    from repro_torch.cluster import (ClusterConfig, LocalCluster,
                                     make_matmul_spec, reap_orphans)
    from repro_torch.serving.queueing import Request

    cfg = ClusterConfig(n_workers=2, n_batches=2, batch_size=1,
                        max_wait=0.01, heartbeat_timeout=5.0,
                        payload=make_matmul_spec(size=256, repeats=2),
                        device="cuda")
    try:
        with LocalCluster(cfg) as cluster:
            coord = cluster.coordinator
            for i in range(6):
                coord.submit(Request(request_id=i, arrival=coord.now()))
            coord.run(timeout=60.0)
            devices = {h.device for h in coord.workers.values()}
    finally:
        reap_orphans()
    assert devices == {"cuda:0"}


def test_one_rank_nccl_collectives_return_the_mean(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.core.replication import (ReplicationPlan,
                                              aggregate_gradients,
                                              make_rdp_mesh)
    from repro_torch.distributed import (hierarchical_allreduce,
                                         replication_aware_pmean)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_rdp_mesh(ReplicationPlan(1, 1), 1)
        tree = {"w": torch.randn((33, 7), device=cuda),
                "b": [torch.randn(5, device=cuda)]}
        group = mesh.get_group("batch")
        outs = [aggregate_gradients(tree, 1.0, m, mesh=mesh)[0]
                for m in ("psum_all", "hierarchical", "weighted")]
        outs += [replication_aware_pmean(tree, group),
                 hierarchical_allreduce(tree, group)]
        for out in outs:
            assert torch.equal(out["w"], tree["w"])
            assert torch.equal(out["b"][0], tree["b"][0])
        _, nb = aggregate_gradients(tree, 0.0, "weighted", mesh=mesh)
        assert float(nb) == 0.0
    finally:
        dist.destroy_process_group()


# -- the training path ------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fn_gradients_match_plain_autograd(cuda, dtype, d, causal):
    """FlashAttentionFn on the card: the forward is one kernel launch, and
    its output and dq / dk / dv lie within the attention tolerances of
    autograd through the plain version."""
    b, s, h, kv = 2, 200, 6, 2
    q, k, v = (_randn((b, s, n, d), seed, cuda, dtype)
               for seed, n in ((11, h), (12, kv), (13, kv)))
    do = _randn((b, s, h, d), 14, cuda, dtype)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = FA.flash_attention_plain(*plain, causal=causal)
    want.backward(do)
    fn = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = launch_counts()
    got = FA.FlashAttentionFn.apply(*fn, causal, 0)
    got.backward(do)
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert after[name] == before[name] + 1, name
    torch.testing.assert_close(got.detach().float(), want.detach().float(),
                               **ATT_TOL[dtype])
    for a, w in zip(fn, plain):
        assert a.grad.dtype == dtype and bool(torch.isfinite(a.grad).all())
        torch.testing.assert_close(a.grad.float(), w.grad.float(),
                                   **ATT_TOL[dtype])


def test_wrappers_without_backward_refuse_grad_on_card(cuda):
    q = _randn((1, 64, 4, 64), 1, cuda, torch.bfloat16).requires_grad_(True)
    k = _randn((1, 64, 2, 64), 2, cuda, torch.bfloat16)
    before = launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        DA.decode_attention(q[:, 0].detach().requires_grad_(True), k, k, 8)
    x = torch.ones((1, 64, 2, 16), device=cuda, requires_grad=True)
    bc = torch.ones((1, 64, 1, 16), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        SS.ssd_scan(x, torch.ones((1, 64, 2), device=cuda),
                    torch.zeros(2, device=cuda), bc, bc,
                    torch.ones(2, device=cuda))
    assert launch_counts() == before


def test_train_loss_backward_reaches_every_parameter_on_card(cuda):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.tree import tree_leaves

    cfg = reduced_config(get_config("qwen2-0.5b"))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 128),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    (lh, _), gh = value_and_grad(cfg, host, batch)
    before = launch_counts()["flash_attention"]
    (lc, _), gc = value_and_grad(cfg, card, {k: v.to(cuda)
                                             for k, v in batch.items()})
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    assert abs(float(lc) - float(lh)) <= 2e-2
    for a, b in zip(tree_leaves(gh), tree_leaves(gc)):
        assert b.is_cuda and bool(torch.isfinite(b).all())
        scale = a.float().abs().max().item()
        assert (b.float().cpu() - a.float()).abs().max().item() <= 5e-2 * scale
    for layer in gc["blocks"]:
        for name in ("wq", "wk", "wv"):
            assert layer["attn"][name].abs().max().item() > 0, name


def test_checkpoint_roundtrip_of_card_bf16(cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import init
    from repro_torch.tree import tree_leaves

    cfg = reduced_config(get_config("qwen2-0.5b"))
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         cuda)
    state = {"params": params, "opt": init(params)}
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, state, {"step": 3})
    ck.wait()
    example = {"params": init_params(torch.Generator(device="cuda")
                                     .manual_seed(1), cfg, cuda)}
    example["opt"] = init(example["params"])
    out, meta = ck.restore(example)
    assert meta == {"step": 3}
    for a, b in zip(tree_leaves(out), tree_leaves(state)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_on_card_keeps_the_cpu_control_plane(cuda):
    from repro_torch.launch.train import Trainer, TrainerConfig

    tc = TrainerConfig(steps=4, seq_len=64, global_batch=16, lr=1e-3)
    host = Trainer(tc, device="cpu")
    card = Trainer(tc)
    assert card.device.type == "cuda"
    card.params = params_to(host.params, cuda)
    card.opt_state = params_to(host.opt_state, cuda)
    before = launch_counts()["flash_attention"]
    rh, rc = host.run(), card.run()
    assert launch_counts()["flash_attention"] - before == 4 * 4 * 4
    assert rc.sim_times == rh.sim_times and rc.plan_history == rh.plan_history
    assert np.abs(np.array(rc.losses) - np.array(rh.losses)).max() <= 2e-2


# -- the hybrid training path and the head-dim-128 dense configs -----------

SCALAR_LEAVES = ("a_log", "dt_bias", "d_skip")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,p,g,n", [(200, 4, 64, 1, 64),
                                       (130, 6, 32, 2, 16)])
def test_ssd_fn_gradients_match_plain_autograd(cuda, dtype, s, h, p, g, n):
    """SsdScanFn on the card, on x, b and c as views of one activation:
    the forward is one kernel launch, its y and final state within the
    scan's tolerances of the plain version, and the gradients (the plain
    numerics' autograd, recomputed) within SSD_TOL of autograd through the
    plain version."""
    b = 2
    gen = torch.Generator(device="cpu").manual_seed(s + h)
    act = torch.randn((b, s, h * p + 2 * g * n), generator=gen)
    act[..., h * p:] *= 0.3
    dt = 0.01 + 0.09 * torch.rand((b, s, h), generator=gen)
    a_log, d_skip = 0.5 * torch.randn(h, generator=gen), 1 + 0.1 * torch.randn(
        h, generator=gen)
    dy = torch.randn((b, s, h, p), generator=gen).to(cuda, dtype)

    def run(fn):
        leaves = [t.to(cuda).requires_grad_(True)
                  for t in (act.to(dtype), dt, a_log, d_skip)]
        xs, bb, cc = leaves[0].split([h * p, g * n, g * n], dim=-1)
        y, st = fn(xs.reshape(b, s, h, p), leaves[1], leaves[2],
                   bb.reshape(b, s, g, n), cc.reshape(b, s, g, n), leaves[3])
        y.backward(dy)
        return y.detach(), st.detach(), [t.grad for t in leaves]

    before = launch_counts()
    y, st, grads = run(lambda *a: SS.SsdScanFn.apply(*a, None, 16))
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("ssd_scan", "ssd_scan_bwd"):
        assert after[name] == before[name] + 1, name
    yp, sp, want = run(lambda *a: SS.ssd_scan_plain(*a, chunk=16))
    _ssd_close(y, yp, SSD_TOL[dtype])
    _ssd_close(st, sp, 1e-4)
    for gr, w in zip(grads, want):
        assert gr.dtype == w.dtype and bool(torch.isfinite(gr).all())
        _ssd_close(gr, w, SSD_TOL[dtype])


# the backward kernels' edge shapes: whisper's cross attention (sq !=
# skv, both ragged), groups 7, 8 and 48, causal with a q_offset (queries
# behind a cached prefix), every head dim; train's shape at batch 2, whose
# dkdv grid (32 blocks) takes the split path (dkdv_splits: 7, one head
# each, summed by the third launch), as most of the small shapes here do
FLASH_BWD_EDGES = [(2, 187, 1500, 8, 8, 64, False, 0),
                   (1, 130, 130, 7, 1, 112, True, 0),
                   (2, 100, 164, 16, 2, 128, True, 64),
                   (1, 70, 70, 48, 1, 128, True, 0),
                   (2, 64, 64, 4, 4, 64, True, 0),
                   (2, 512, 512, 14, 2, 64, True, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,off", FLASH_BWD_EDGES)
def test_flash_bwd_kernel_matches_the_plain_backward(cuda, dtype, b, sq, skv,
                                                     h, kv, d, causal, off):
    """FlashAttentionFn's backward on the card is one ``flash_attention_bwd``
    count and within the attention tolerances of ``flash_attention_grad``
    (the plain backward) on the same inputs; two passes are bit-equal."""
    q = _randn((b, sq, h, d), 51, cuda, dtype)
    k = _randn((b, skv, kv, d), 52, cuda, dtype)
    v = _randn((b, skv, kv, d), 53, cuda, dtype)
    do = _randn((b, sq, h, d), 54, cuda, dtype)

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = FA.FlashAttentionFn.apply(*leaves, causal, off)
        return torch.autograd.grad(out, leaves, do)

    before = launch_counts()["flash_attention_bwd"]
    got = grads()
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    want = FA.flash_attention_grad(q, k, v, do, causal=causal, q_offset=off)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        torch.testing.assert_close(a.float(), w.float(), **ATT_TOL[dtype],
                                   msg=name)
    again = grads()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_is_the_rows_logsumexp(cuda, dtype):
    """The trainable forward's LSE: each row's log-sum-exp of the scaled
    float32 logits of its visible keys; in bfloat16 its output residual
    out_lo, what rounding each float32 output to bf16 dropped."""
    b, sq, skv, h, kv, d, off = 2, 150, 214, 6, 2, 112, 64
    q = _randn((b, sq, h, d), 55, cuda, dtype)
    k = _randn((b, skv, kv, d), 56, cuda, dtype)
    out, lse, out_lo = FA._attend(q, k, k, True, off, with_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert (out_lo is None) == (dtype == torch.float32)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                     FA.repeat_kv(k, h).float()) * d ** -0.5
    vis = (torch.arange(sq, device=cuda)[:, None] + off
           >= torch.arange(skv, device=cuda)[None, :])
    want = torch.where(vis, s, -torch.inf).logsumexp(-1)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out, FA.flash_attention(q, k, k, q_offset=off),
                               atol=0, rtol=0)
    if out_lo is not None:  # about half a bf16 spacing of each output
        lo = out_lo.float().abs()
        assert bool((lo <= out.float().abs() * 2.0 ** -7 + 1e-38).all())
        assert (lo > 0).float().mean().item() > 0.5


# (S, H, P, G, N, initial state, final-state cotangent); the last: S not
# a multiple of 64 over 8 chunks, with an initial state, so the reverse
# scan carries dS' across every chunk's block
SSD_BWD_EDGES = [(200, 4, 64, 1, 64, True, True),
                 (130, 6, 32, 2, 16, False, True),
                 (64, 2, 128, 1, 128, True, False),
                 (100, 4, 16, 2, 128, False, False),
                 (300, 3, 64, 3, 32, True, True),
                 (450, 8, 64, 2, 64, True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,p,g,n,init,with_dstate", SSD_BWD_EDGES)
def test_ssd_bwd_kernel_matches_the_plain_backward(cuda, dtype, s, h, p, g,
                                                   n, init, with_dstate):
    """SsdScanFn's backward on the card is one ``ssd_scan_bwd`` count and
    its seven gradients lie within the scan's tolerances (1e-4 x (1 +
    |plain|) in float32, 5e-2 in bfloat16) of ``ssd_scan_grad``, with and
    without an initial state and a final-state cotangent, at 1 to 3 B/C
    groups and P, N from 16 to 128; two passes are bit-equal."""
    b = 2
    ins = _ssd_inputs(s + 7 * h, b, s, h, p, g, n, dtype, cuda, init=init)
    dy = _randn((b, s, h, p), 57, cuda, dtype)
    dstate = _randn((b, h, n, p), 58, cuda, torch.float32) if with_dstate \
        else None

    def grads():
        leaves = [None if t is None else t.clone().requires_grad_(True)
                  for t in ins]
        y, st = SS.SsdScanFn.apply(*leaves, 16)
        outs, cots = [y], [dy]
        if dstate is not None:
            outs.append(st)
            cots.append(dstate)
        want = [t for t in leaves if t is not None]
        return torch.autograd.grad(outs, want, cots)

    before = launch_counts()["ssd_scan_bwd"]
    got = grads()
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan_bwd"] == before + 1
    want = [w for w in SS.ssd_scan_grad(*ins, dy, dstate, 16) if w is not None]
    assert len(got) == len(want) == (7 if init else 6)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        _ssd_close(a, w, SSD_TOL[dtype])
    again = grads()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_backward_kernels_raise_without_the_forwards_buffers(cuda):
    """No fallback: the card's backwards refuse what they cannot run."""
    q = _randn((1, 64, 2, 64), 59, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="LSE"):
        FA._attend_grad(q, q, q, q, q, None, q, True, 0)
    with pytest.raises(ValueError, match="residual"):
        FA._attend_grad(q, q, q, q, None, torch.zeros((1, 2, 64), device=cuda),
                        q, True, 0)
    ins = _ssd_inputs(60, 1, 64, 2, 16, 1, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="chunk states"):
        SS._scan_grad(*ins, None, ins[0], None, 16, (True,) * 7)


@pytest.mark.parametrize("h,kv", [(40, 8), (96, 8), (48, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_dense_configs_heads(cuda, h, kv, dtype):
    """Head dim 128 at qwen2.5-14b's, command-r-plus-104b's and
    granite-34b's groups (5, 12 and 48 query heads a KV head): flash over a
    ragged 200-position prompt, decode over a 1,055-position cache.  In
    bfloat16 decode is held within a tenth of the plain output's RMS plus
    2^-6 of each element (four bf16 spacings: over 20,480 outputs a few
    lie far above the RMS, where the kernel's and the plain version's
    bf16 roundings of P and of the output differ by a spacing there)."""
    q = _randn((2, 200, h, 128), 21, cuda, dtype)
    k = _randn((2, 200, kv, 128), 22, cuda, dtype)
    v = _randn((2, 200, kv, 128), 23, cuda, dtype)
    out = FA.flash_attention(q, k, v, causal=True)
    ref = FA.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **ATT_TOL[dtype])
    qd = _randn((4, h, 128), 24, cuda, dtype)
    kc = _randn((4, 2048, kv, 128), 25, cuda, dtype)
    vc = _randn((4, 2048, kv, 128), 26, cuda, dtype)
    before = launch_counts()["decode_attention"]
    out = DA.decode_attention(qd, kc, vc, 1055)
    assert launch_counts()["decode_attention"] == before + 1
    ref = DA.decode_attention_plain(qd, kc, vc, 1055)
    if dtype == torch.bfloat16:
        rms = ref.float().square().mean().sqrt().item()
        tol = dict(atol=DECODE_BF16_RMS_FRAC * rms, rtol=2.0 ** -6)
    else:
        tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "command-r-plus-104b",
                                  "granite-34b"])
def test_dense_configs_on_card_match_cpu(cuda, arch):
    """The reduced models of the three head-dim-128 configs: prefill and
    two decode steps on the card meet the CPU's logits within 4e-2 (the
    untied qwen2.5-14b's logits, of unit scale and more, within 1e-1)."""
    cfg = reduced_config(get_config(arch))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    (lh, sh), (lc, sc) = (prefill(cfg, p, {"tokens": toks}, 80)
                          for p in (host, card))
    atol = 4e-2 if cfg.tie_embeddings else 1e-1
    for i in range(3):
        torch.testing.assert_close(lc.float().cpu(), lh.float(), atol=atol,
                                   rtol=0)
        tok = lh[:, -1].argmax(-1, keepdim=True)
        lh, sh = decode_step(cfg, host, sh, tok, 70 + i)
        lc, sc = decode_step(cfg, card, sc, tok.to(cuda), 70 + i)


def test_hybrid_train_loss_backward_reaches_every_parameter_on_card(cuda):
    """Reduced zamba2's ``train_loss`` backward on the card: one
    ``ssd_scan`` launch a Mamba-2 block and one flash launch a shared
    application, every leaf finite, the scan-only leaves nonzero, the loss
    within 2e-2 of the CPU's and each leaf within 5e-2 of its largest CPU
    gradient (the per-head float32 leaves within 0.25, as against the
    reference on the CPU)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.zamba import segment_layout
    from repro_torch.tree import tree_leaves

    cfg = reduced_config(get_config("zamba2-7b"))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 128),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    (lh, _), gh = value_and_grad(cfg, host, batch)
    before = launch_counts()
    (lc, _), gc = value_and_grad(cfg, card, {k: v.to(cuda)
                                             for k, v in batch.items()})
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["ssd_scan"] - before["ssd_scan"] == cfg.n_layers
    assert (after["flash_attention"] - before["flash_attention"]
            == segment_layout(cfg)[0])
    assert abs(float(lc) - float(lh)) <= 2e-2
    names = [n for n, _ in _named_leaves(gh)]
    for name, a, b in zip(names, tree_leaves(gh), tree_leaves(gc)):
        assert b.is_cuda and bool(torch.isfinite(b).all())
        scale = a.float().abs().max().item()
        tol = 0.25 if name in SCALAR_LEAVES else 5e-2
        assert (b.float().cpu() - a.float()).abs().max().item() <= tol * scale
    for seg in gc["mamba_segments"]:
        for lp in seg:
            for name in ("a_log", "dt_bias", "conv_w"):
                assert lp[name].abs().max().item() > 0, name


def _named_leaves(tree, name=None):
    """(last key, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def test_hybrid_trainer_on_card_keeps_the_cpu_control_plane(cuda):
    from repro_torch.launch.train import Trainer, TrainerConfig

    tc = TrainerConfig(arch="zamba2-7b", steps=4, seq_len=64,
                       global_batch=16, lr=1e-3)
    host = Trainer(tc, device="cpu")
    card = Trainer(tc)
    card.params = params_to(host.params, cuda)
    card.opt_state = params_to(host.opt_state, cuda)
    before = launch_counts()["ssd_scan"]
    rh, rc = host.run(), card.run()
    assert launch_counts()["ssd_scan"] - before == 4 * 4 * card.cfg.n_layers
    assert rc.sim_times == rh.sim_times and rc.plan_history == rh.plan_history
    assert np.abs(np.array(rc.losses) - np.array(rh.losses)).max() <= 2e-2


# -- the MoE, VLM, audio and xLSTM families --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (32, 1500), (1, 1500)])
def test_flash_non_causal_at_whisper_shapes(cuda, dtype, sq, skv):
    """Whisper's encoder (1,500 x 1,500) and cross attention (decoder
    queries over 1,500 frames, sq != skv, skv not a multiple of the tile),
    d 64, non-causal."""
    q = _randn((8, sq, 16, 64), 31, cuda, dtype)
    k = _randn((8, skv, 16, 64), 32, cuda, dtype)
    v = _randn((8, skv, 16, 64), 33, cuda, dtype)
    out = FA.flash_attention(q, k, v, causal=False)
    ref = FA.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), ref.float(), **ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,smax,cache_len", [
    (16, 16, 128, 2048, 1055),  # olmoe / deepseek-moe: MHA, group 1
    (16, 16, 64, 1536, 1500),  # whisper's cross cache, 1,500 frames
    (64, 8, 128, 2048, 1311)])  # internvl2: patches + prompt + 31 steps
def test_decode_at_the_family_caches(cuda, dtype, h, kv, d, smax, cache_len):
    qd = _randn((8, h, d), 34, cuda, dtype)
    kc = _randn((8, smax, kv, d), 35, cuda, dtype)
    vc = _randn((8, smax, kv, d), 36, cuda, dtype)
    before = launch_counts()["decode_attention"]
    out = DA.decode_attention(qd, kc, vc, cache_len)
    assert launch_counts()["decode_attention"] == before + 1
    ref = DA.decode_attention_plain(qd, kc, vc, cache_len)
    if dtype == torch.bfloat16:
        rms = ref.float().square().mean().sqrt().item()
        tol = dict(atol=DECODE_BF16_RMS_FRAC * rms, rtol=2.0 ** -6)
    else:
        tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_apply_moe_on_card_matches_cpu(cuda, arch, capacity_factor):
    """One MoE layer at full width (d 2048, 64 experts) on 2 x 64 tokens,
    the same weights on the card and the CPU: the same experts chosen, the
    same assignments dropped, outputs within 2e-2 (bf16) of the CPU's and
    the aux loss within 1e-6.  The dispatch makes no host sync."""
    from repro_torch.models import moe as M

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    host = M.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    card = params_to(host, cuda)
    x = _randn((2, 64, cfg.d_model), 37, "cpu", torch.bfloat16)
    yh, auxh = M.apply_moe(cfg, host, x)
    xc = x.to(cuda)
    _, _, eh = M.route(cfg.moe, host["router"], x.reshape(-1, cfg.d_model))
    _, _, ec = M.route(cfg.moe, card["router"], xc.reshape(-1, cfg.d_model))
    assert torch.equal(eh.sort(-1).values, ec.sort(-1).values.cpu())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yc, auxc = M.apply_moe(cfg, card, xc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(yc.float().cpu(), yh.float(), atol=2e-2,
                               rtol=2e-2)
    assert abs(float(auxc) - float(auxh)) <= 1e-6


def test_mlstm_chunked_on_card_matches_cpu(cuda):
    """xlstm-350m's mLSTM shape (4 heads, dk 256, dv 512), 2 rows of 256
    positions in chunks of 128, float32: within 1e-4 x (1 + |CPU|)."""
    from repro_torch.models import xlstm as X

    g = torch.Generator().manual_seed(38)
    q, k = (torch.randn((2, 256, 4, 256), generator=g) for _ in range(2))
    v = torch.randn((2, 256, 4, 512), generator=g)
    i_pre = torch.randn((2, 256, 4), generator=g)
    f_pre = 2.0 + torch.randn((2, 256, 4), generator=g)
    hh, (ch, nh, mh) = X.mlstm_chunked(q, k, v, i_pre, f_pre, 128)
    hc, st = X.mlstm_chunked(*(t.to(cuda) for t in (q, k, v, i_pre, f_pre)),
                             128)
    for got, want in zip((hc,) + st, (hh, ch, nh, mh)):
        got = got.cpu()
        assert bool(((got - want).abs()
                     <= 1e-4 * (1 + want.abs())).all()), (
            (got - want).abs().max())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "internvl2-76b", "xlstm-350m"])
def test_family_models_on_card_match_cpu(cuda, arch, monkeypatch):
    """The reduced models: prefill (vlm: behind its patch slots) and two
    decode steps on the card meet the CPU's logits within 4e-2 (untied,
    logits of unit scale and more: within 1e-1).  MoE: the card is routed
    to the CPU's experts call by call, and each token whose own top-k set
    would differ (a bf16 near-tie ordered the other way) must be a
    near-tie, the CPU's margin below 1e-2."""
    from repro_torch.models import moe as M

    cfg = reduced_config(get_config(arch))
    route, routing = routed_to_cpu(M.route)
    monkeypatch.setattr(M, "route", route)
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    batch, off = {"tokens": toks}, 0
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.n_patches, cfg.frontend_dim), generator=g)
        off = cfg.n_patches
    lh, sh = prefill(cfg, host, batch, off + 80)
    lc, sc = prefill(cfg, card, batch, off + 80)
    atol = 4e-2 if cfg.tie_embeddings else 1e-1
    for i in range(3):
        torch.testing.assert_close(lc.float().cpu(), lh.float(), atol=atol,
                                   rtol=0)
        tok = lh[:, -1].argmax(-1, keepdim=True)
        lh, sh = decode_step(cfg, host, sh, tok, off + 64 + i)
        lc, sc = decode_step(cfg, card, sc, tok.to(cuda), off + 64 + i)
    assert not routing["pending"]
    assert all(m < 1e-2 for m in routing["flips"]), routing["flips"]


def test_whisper_on_card_matches_cpu(cuda):
    """Reduced whisper: encode 100 frames, the cross cache, three decode
    steps over all of them, on the card and the CPU: logits within 4e-2;
    decode_train on the card within 4e-2 of its own steps."""
    from repro_torch.models import whisper as W

    cfg = reduced_config(get_config("whisper-medium"))
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = params_to(host, cuda)
    frames = torch.randn((2, 100, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 3),
                         generator=torch.Generator().manual_seed(2))
    steps = {}
    for where, p in (("cpu", host), (cuda, card)):
        enc = W.encode(cfg, p, frames.to(where))
        cache = init_decode_state(cfg, 2, 128, where)
        for i, lp in enumerate(p["dec_blocks"]):
            k, v = W._cross_kv(cfg, lp, enc)
            cache["cross_k"][i][:, :100] = k
            cache["cross_v"][i][:, :100] = v
        out = []
        for i in range(3):
            lg, cache = W.decode_step(cfg, p, cache, toks[:, i:i + 1].to(where),
                                      i, 100)
            out.append(lg)
        steps[str(where)] = (torch.cat(out, 1).float().cpu(), enc)
    torch.testing.assert_close(steps["cuda"][0], steps["cpu"][0], atol=4e-2,
                               rtol=0)
    full = W.decode_train(cfg, card, toks.to(cuda), steps["cuda"][1])
    torch.testing.assert_close(full.float().cpu(), steps["cuda"][0],
                               atol=4e-2, rtol=0)
