"""The Hopper k-of-N selection's algorithms, emulated on the CPU.

``csrc/coded_cells.cu`` has two paths, and this file does in numpy what
each does, step for step:

- :func:`short_rows` — rows of N <= 64: a sub-group of W lanes a row (W the
  next power of two >= N, capped at 32; two values a lane above 32), 32/W
  neighbouring rows a warp.  Pad lanes hold +inf; the sub-group sorts its
  values by a bitonic network of shuffles (a swap within the lane at the
  stride 32 when a lane holds two), and lane (k-1) % W writes element k-1.
- :class:`RadixRow` — rows of any N, one 256-thread block a row: the row's
  order-preserving keys and their range [lo, hi] as it is read; then passes
  of the 8-bit digit ``(key - lo) >> s`` (``s`` brings the range under 256
  bins) counted in eight per-warp histograms, merged and scanned
  block-wide (a shuffle scan a warp, then the warps' totals) to find the
  bin that holds the k-th; a filter pass compacts the bin's keys into a
  1,024-key buffer, or, when they do not fit, keeps reading the row through
  the bin's range; it ends when the range is one key, or when at most 32
  candidates are left, which one warp sorts by the same network.

Both are held bit-for-bit (as uint32 images of the floats) against the
reference's numpy oracle ``coded_completion_reference``, its Pallas kernel
``coded_completion_cells(..., backend="pallas")`` in interpret mode, and
the port's ``coded_cells_plain``, over N at every edge of the two paths, k
in {1, N//2, N}, and rows of service times, of duplicates, of one value,
and holding +inf.  The candidates each radix pass leaves are pinned on the
planner's and the fleet's rows, and held equal to the port's plain
``coded_radix_counts_plain``, which the card's kernel is held to.
"""

import numpy as np
import pytest
import torch

from repro.kernels.sojourn_sweep import ops as RO
from repro.kernels.sojourn_sweep.ref import coded_completion_reference
from repro_torch.kernels.sojourn_sweep import kernel as K

F32 = np.float32
U32 = np.uint32
THREADS = 256
WARPS = THREADS // 32
BITS = 8
BINS = 1 << BITS
CAND_CAP = 1024
RANK_MAX = 32
MAX_PASSES = 4
NS = [1, 2, 3, 15, 16, 17, 31, 32, 33, 63, 64, 65, 1000, 10_000]


def keys_of(x):
    """The kernel's order-preserving uint32 key of each float32."""
    u = np.asarray(x, F32).view(U32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def float_of(key):
    key = np.uint64(key)
    u = key & 0x7FFFFFFF if key & 0x80000000 else ~key & 0xFFFFFFFF
    return np.array(u, U32).view(F32)[()]


# ---------------------------------------------------------------------------
# the short-row path: coded_warp_kernel<W, V>
# ---------------------------------------------------------------------------


def short_width(n):
    """(W lanes a row, V values a lane) of the launch for rows of n."""
    if n > 32:
        return 32, 2
    w = 1
    while w < n:
        w <<= 1
    return w, 1


def bitonic_sort(vals, w):
    """The kernel's ``bitonic_sort<W, V>`` over every thread at once:
    ``vals[u][t]`` is thread t's v[u], element e = (t % w) + u w of its
    sub-group; a stride below w reads lane t ^ stride (a shuffle), the
    stride w the thread's other value."""
    v_per = len(vals)
    t = np.arange(vals[0].size)
    i = t & (w - 1)
    size = 2
    while size <= w * v_per:
        stride = size >> 1
        while stride > 0:
            part = [vals[(u ^ 1) & (v_per - 1)] if stride >= w
                    else vals[u][t ^ stride] for u in range(v_per)]
            new = []
            for u in range(v_per):
                e = i + u * w
                keep_min = ((e & size) == 0) == ((e & stride) == 0)
                new.append(np.where(keep_min, np.minimum(vals[u], part[u]),
                                    np.maximum(vals[u], part[u])))
            vals = new
            stride >>= 1
        size <<= 1
    return vals


def short_rows(times, ks):
    """(C,T,N) float32 -> (C,T): the threads of the short-row kernel."""
    n_cells, n_trials, n = times.shape
    w, v_per = short_width(n)
    rows = n_cells * n_trials
    n_thr = -(-rows * w // THREADS) * THREADS  # whole 256-thread blocks
    t = np.arange(n_thr)
    row, i = t // w, t & (w - 1)
    active = row < rows
    flat = times.reshape(rows, n)
    safe = np.minimum(row, rows - 1)
    vals = []
    for u in range(v_per):  # v[u] = x[i + u W]; +inf pads
        j = i + u * w
        vals.append(np.where(active & (j < n),
                             flat[safe, np.minimum(j, n - 1)], F32(np.inf)))
    vals = bitonic_sort(vals, w)
    e = np.where(active, np.repeat(ks, n_trials)[safe] - 1, -1)
    val = vals[0]
    for u in range(1, v_per):
        val = np.where(e >= u * w, vals[u], val)
    writer = (e >= 0) & ((e & (w - 1)) == i)
    assert np.array_equal(np.bincount(row[writer], minlength=rows)[:rows],
                          np.ones(rows))
    out = np.empty(rows, F32)
    out[row[writer]] = val[writer]
    return out.reshape(n_cells, n_trials)


# ---------------------------------------------------------------------------
# the long-row path: coded_radix_kernel
# ---------------------------------------------------------------------------


def element_warps(n):
    """The warp that reads each element in a pass over the staged row:
    thread j % 256 reads uint4 j (elements 4j..4j+3), then the tail."""
    i = np.arange(n)
    n4 = n >> 2
    thread = np.where(i < 4 * n4, (i >> 2) % THREADS, (i - 4 * n4) % THREADS)
    return thread >> 5


def block_scan(cnt):
    """Exclusive prefix of 256 bin counts as the kernel takes it: a
    shuffle-up inclusive scan in each warp, then the warps' totals."""
    incl = cnt.astype(np.int64).reshape(WARPS, 32).copy()
    for d in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(incl)
        shifted[:, d:] = incl[:, :-d]
        incl = incl + shifted
    wsum = incl[:, 31]
    base = np.concatenate([[0], np.cumsum(wsum)[:-1]])
    return (incl + base[:, None]).reshape(-1) - cnt


def sort_warp(cand, m, k):
    """One warp sorts at most 32 keys (pads 0xFFFFFFFF) by the bitonic
    network; lane k-1 holds the k-th."""
    v = np.full(32, 0xFFFFFFFF, np.uint64)
    v[:m] = cand[:m]
    return bitonic_sort([v], 32)[0][k - 1]


class RadixRow:
    """One block of the radix kernel on one row; ``counts`` holds the
    candidates each pass left (the kernel's ``pass_counts``)."""

    def __init__(self, row, k):
        keys = keys_of(row)
        warp = element_warps(keys.size)
        lo, hi = int(keys.min()), int(keys.max())
        src = None  # None: the full row (staged in shared memory)
        m = keys.size
        self.counts = []
        p = 0
        while True:
            if lo == hi:
                self.key = lo
                break
            if src is not None and m <= RANK_MAX:
                self.key = int(sort_warp(src, m, k))
                break
            span = hi - lo
            s = max(0, span.bit_length() - BITS)
            cand = keys if src is None else src
            cw = warp if src is None else np.arange(cand.size) % THREADS >> 5
            off = cand.astype(np.int64) - lo
            inr = (off >= 0) & (off <= span)
            assert p > 0 or inr.all()
            hist = np.zeros((WARPS, BINS), np.int64)
            np.add.at(hist, (cw[inr], off[inr] >> s), 1)
            cnt = hist.sum(0)  # thread b merges bin b
            excl = block_scan(cnt)
            digit = int(np.flatnonzero((excl < k) & (k <= excl + cnt))[0])
            assert digit < BINS and len(np.flatnonzero(
                (excl < k) & (k <= excl + cnt))) == 1
            nlo = lo + (digit << s)
            nspan = min((1 << s) - 1, hi - nlo)
            k -= int(excl[digit])
            m = int(cnt[digit])
            self.counts.append(m)
            keep = (cand.astype(np.int64) - nlo >= 0) & (
                cand.astype(np.int64) - nlo <= nspan)
            assert keep.sum() == m
            lo, hi = int(cand[keep].min()), int(cand[keep].max())
            if m <= CAND_CAP:
                src = cand[keep]  # compacted (the kernel's order is its
                # atomics'; the selection does not depend on it)
            p += 1
            assert p <= MAX_PASSES
        self.value = float_of(self.key)
        self.counts += [0] * (MAX_PASSES - len(self.counts))


def radix_rows(times, ks):
    n_cells, n_trials, _ = times.shape
    out = np.empty((n_cells, n_trials), F32)
    counts = np.zeros((n_cells, n_trials, MAX_PASSES), np.int64)
    for c in range(n_cells):
        for t in range(n_trials):
            r = RadixRow(times[c, t], int(ks[c]))
            out[c, t] = r.value
            counts[c, t] = r.counts
    return out, counts


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def service_rows(rng, n_rows, n, s):
    """SExp(0.05, 2.0) draws at an MDS(s) load N/(N-s), as the coded sweep
    builds its cells: float64 times cast once to float32."""
    load = n / (n - s)
    return ((0.05 + rng.standard_exponential((n_rows, n)) / 2.0)
            * load).astype(F32)


def mixed_rows(n, seed=0):
    """(3, 14, n): each cell holds exponential rows, the floor(x 4)/4
    pattern, phase 7's copy of every 7th value, a row of one value, rows
    holding +inf, and service-time rows."""
    rng = np.random.default_rng(seed + n)
    out = []
    for _ in range(3):
        exp = rng.exponential(1.0, (2, n)).astype(F32)
        floor = (np.floor(rng.exponential(1.0, (2, n)) * 4) / 4).astype(F32)
        dup = rng.exponential(1.0, (2, n)).astype(F32)
        every7 = np.arange(0, n - 1, 7)
        dup[:, every7] = dup[:, every7 + 1]
        equal = np.full((2, n), rng.exponential(), F32)
        inf = rng.exponential(1.0, (2, n)).astype(F32)
        inf[0, rng.integers(0, n, max(1, n // 5))] = np.inf
        inf[1] = np.inf
        inf[1, : n // 2] = F32(0.75)
        svc = service_rows(rng, 4, n, max(0, n // 4))
        out.append(np.concatenate([exp, floor, dup, equal, inf, svc]))
    return np.stack(out)


def quorums(n):
    return np.array([1, max(1, n // 2), n], np.int32)


def bits(x):
    return np.asarray(x, F32).view(U32)


@pytest.mark.parametrize("n", NS)
def test_emulated_paths_bit_equal_reference(n):
    """Both paths' emulations equal the numpy oracle, the reference's Pallas
    kernel (interpret mode) and the port's plain version, bit for bit."""
    times = mixed_rows(n)
    ks = quorums(n)
    ref = coded_completion_reference(times, ks)
    pallas = np.asarray(RO.coded_completion_cells(times, ks, backend="pallas"))
    plain = K.coded_cells_plain(torch.from_numpy(times),
                                torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(bits(pallas), bits(ref))
    np.testing.assert_array_equal(bits(plain), bits(ref))
    radix, counts = radix_rows(times, ks)
    np.testing.assert_array_equal(bits(radix), bits(ref))
    if n <= 64:
        np.testing.assert_array_equal(bits(short_rows(times, ks)), bits(ref))
    # the plain twin of the kernel's pass counts runs the same passes
    twin = K.coded_radix_counts_plain(torch.from_numpy(times),
                                      torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(twin, counts)
    # a row of one value needs no pass; no row needs more than four
    assert (counts[:, 6:8] == 0).all()
    assert (counts >= 0).all()


@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 33, 63, 64])
def test_short_rows_pads_never_selected(n):
    """Rows of +inf and rows whose largest value repeats at the end: the
    +inf pads sort after the row, element k-1 is the row's k-th, and one
    lane a row writes it (the emulation asserts one writer a row)."""
    rng = np.random.default_rng(n)
    times = np.full((2, 40, n), np.inf, F32)
    times[1] = rng.exponential(1.0, (40, n)).astype(F32)
    times[1, :, -1] = times[1].max()
    for ks in (np.array([1, n], np.int32), np.array([n, 1], np.int32)):
        np.testing.assert_array_equal(bits(short_rows(times, ks)),
                                      bits(coded_completion_reference(times,
                                                                      ks)))


def test_short_rows_many_warps_and_ragged_tail():
    """Rows that end inside a warp and a block (5 x 333 rows of 12 values:
    16 lanes a row, the last block half full), k different per cell."""
    rng = np.random.default_rng(3)
    times = rng.exponential(1.0, (5, 333, 12)).astype(F32)
    times[:, ::3, 5] = times[:, ::3, 6]
    ks = np.array([1, 4, 6, 11, 12], np.int32)
    np.testing.assert_array_equal(bits(short_rows(times, ks)),
                                  bits(coded_completion_reference(times, ks)))


# per-pass candidates on the planner's rows (N = 16, mds s in {4, 8, 12})
# and the fleet's (N = 10,000, mds s in {100, 1,000, 2,500}), 6 rows each,
# seed 0: the first pass, and (where more than 32 were left) the second;
# and, beside them, the keys that share the k-th's top byte, which a first
# digit of the sign and seven exponent bits would have kept
PINNED_COUNTS = {
    (16, 4): ([1] * 6, [0] * 6, [9, 7, 9, 5, 8, 9]),
    (16, 8): ([1] * 6, [0] * 6, [8, 9, 12, 7, 9, 7]),
    (16, 12): ([1] * 6, [0] * 6, [4, 7, 8, 9, 7, 2]),
    (10_000, 100): ([16, 14, 15, 13, 10, 22], [0] * 6,
                    [209, 202, 201, 215, 210, 209]),
    (10_000, 1_000): ([73, 46, 59, 48, 50, 60], [1] * 6,
                      [4148, 4204, 4145, 4301, 4122, 4187]),
    (10_000, 2_500): ([61, 71, 56, 108, 70, 64], [1, 1, 1, 1, 2, 1],
                      [4596, 4695, 4563, 4728, 4615, 4644]),
}


def fleet_rows(n, s, n_rows=6):
    return service_rows(np.random.default_rng(0), n_rows, n, s)[None]


@pytest.mark.parametrize("n,s", sorted(PINNED_COUNTS))
def test_radix_counts_on_service_rows(n, s):
    """The first digit spans the row's own range, so on service times one
    pass leaves at most about a hundred keys of 10,000, a second at most
    two, and no row runs a third; a first digit of the key's top byte would
    keep 200 to 4,700 (some 40% of the row at s = 1,000 and 2,500)."""
    times = fleet_rows(n, s)
    ks = np.array([n - s], np.int32)
    out, counts = radix_rows(times, ks)
    np.testing.assert_array_equal(bits(out),
                                  bits(coded_completion_reference(times, ks)))
    twin = K.coded_radix_counts_plain(torch.from_numpy(times),
                                      torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(twin, counts)
    first, second, top_byte = PINNED_COUNTS[(n, s)]
    assert counts[0, :, 0].tolist() == first
    assert counts[0, :, 1].tolist() == second
    assert (counts[0, :, 2:] == 0).all()
    kth = [keys_of(np.sort(r)[n - s - 1]) >> 24 for r in times[0]]
    assert [int((keys_of(r) >> 24 == b).sum())
            for r, b in zip(times[0], kth)] == top_byte


def test_radix_counts_on_phase7_duplicates():
    """Phase 7's long rows (every 7th value a copy of its neighbour), at
    k 9,000 and 9,988: the candidates after each pass, pinned."""
    g = torch.Generator(device="cpu").manual_seed(7)
    big = torch.empty((2, 6, 10_000)).exponential_(generator=g)
    big[:, :, ::7] = big[:, :, 1::7][:, :, : big[:, :, ::7].shape[2]]
    times = big.numpy()
    ks = np.array([9000, 9988], np.int32)
    out, counts = radix_rows(times, ks)
    np.testing.assert_array_equal(bits(out),
                                  bits(coded_completion_reference(times, ks)))
    np.testing.assert_array_equal(
        K.coded_radix_counts_plain(big, torch.from_numpy(ks)).numpy(), counts)
    assert counts[0, :, :2].tolist() == [[136, 3], [262, 2], [248, 5],
                                         [268, 1], [253, 4], [291, 5]]
    assert counts[1, :, :2].tolist() == [[7, 0], [11, 0], [4, 0], [9, 0],
                                         [9, 0], [7, 0]]
    assert (counts[..., 2:] == 0).all()


def test_radix_rows_past_the_candidate_buffer():
    """A bin of more than 1,024 keys is not compacted: the next pass reads
    the whole row through the bin's range.  Here the lowest 5,000 values
    are 0.5 and the float just above it, one bin of the first pass; the
    second splits them and the third finds one key."""
    rng = np.random.default_rng(11)
    row = np.concatenate([np.full(3000, 0.5, F32),
                          np.nextafter(np.full(2000, 0.5, F32), F32(1)),
                          1 + rng.exponential(1.0, 3000).astype(F32)])
    times = rng.permutation(row)[None, None]
    for k, counts in ((1, [5000, 3000]), (3000, [5000, 3000]),
                      (3001, [5000, 2000]), (5000, [5000, 2000])):
        r = RadixRow(times[0, 0], k)
        assert bits(r.value) == bits(coded_completion_reference(
            times, np.array([k], np.int32)))[0, 0]
        assert r.counts[:2] == counts and r.counts[2:] == [0, 0]
    r = RadixRow(times[0, 0], 5001)
    assert r.counts[0] < CAND_CAP and r.value > 1
