"""The Hopper sojourn scan's algorithm, emulated on the CPU, against ref.py.

``csrc/sojourn_cells.cu`` runs every (cell, policy) program of a sweep in
one launch, one warp a program, over two tournament trees: one over the
sets' free times keyed by (free, index) that keeps the lowest two, one
over the armed triggers keyed by (effective time, job id, index).
:class:`TreeScan` below does in numpy float32 what one program of the
kernel does, step for step:

- sets form nodes of 128 (four a lane); keys are the order-preserving
  uint32 image of the floats (-0 and +0 share one); a set at or past
  ``n_groups`` holds +inf and is never written, so it loses every tie;
- a change re-reduces its node from the node's sets, and the root from the
  other nodes and the changed node's sets;
- the hedge's idle set is the free root's second (the runner-up of g); a
  clone's idle set is the free tree's root;
- clone triggers are advanced lazily at the root, with the full
  recomputation from base times when m falls below the largest m a stored
  trigger was advanced with (only negative draws can do that);
- a relaunch's redraw is read when it arms and parked one job later;
- each program reads its own ``n_groups[c]`` out of rows padded to the
  launch's widest ``G``, and resolves triggers only when ``resolve`` is set
  and its policy can arm one.

The kernel's prefetch of the next jobs' draws changes no value and is left
out.  The
emulation is held bit-for-bit against ``repro``'s numpy oracle
``sojourn_cells_reference`` and the port's plain ``sojourn_cells_plain``.
A last test holds ``sweep_sojourn_policies`` through the one-call seam
against the reference's ``pallas`` lane.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.core import simulator as RS
from repro.core.order_stats import Empirical as REmp
from repro.core.order_stats import ShiftedExponential as RSExp
from repro.core.policies import PolicyCandidate as RPol
from repro.kernels.sojourn_sweep.ref import sojourn_cells_reference
from repro_torch.convert import from_reference
from repro_torch.core import simulator as TS
from repro_torch.kernels.sojourn_sweep import kernel as K
from repro_torch.kernels.sojourn_sweep import ops as O

F32 = np.float32
INF = F32(np.inf)
NONE = 0xFFFFFFFF
GROUPS = [1, 2, 31, 32, 33, 64, 257, 2000]


def fkey(x) -> int:
    """The kernel's order-preserving key of a float32."""
    b = int(np.asarray(x, dtype=F32).view(np.uint32))
    if (b << 1) & 0xFFFFFFFF == 0:
        b = 0
    return (~b) & 0xFFFFFFFF if b & 0x80000000 else b | 0x80000000


INT_MAX = 2**31 - 1
KNONE = 0xFFFFFFFF


def kval(key):
    """The kernel's float of an order-preserving key (zeros come back +0)."""
    bits = key & 0x7FFFFFFF if key & 0x80000000 else (~key) & 0xFFFFFFFF
    return np.array(bits, np.uint32).view(F32)[()]


def _top2(pairs):
    """The lowest two (key, index) pairs; (KNONE, INT_MAX) when absent."""
    out = sorted(pairs)[:2]
    return tuple(out + [(KNONE, INT_MAX)] * (2 - len(out)))


class TreeScan:
    """One program of the kernel: a cell's scan under one policy.

    Sets form nodes of ``fan`` (128 in the kernel, four a lane); a node's
    lowest two free keys and its lowest trigger are kept per node, and a
    walk re-reduces a changed node from its sets and the root from the
    other nodes and the changed node's sets.
    """

    def __init__(self, arr, svc, alt, kind, thr, hmask, ng, resolve,
                 fan=128):
        self.arr, self.svc, self.alt = arr, svc, alt
        self.kind, self.thr, self.hmask = kind, F32(thr), hmask
        self.ng, self.fan = ng, fan
        gp = -(-max(svc.shape[1], 1) // fan) * fan
        self.n_nodes = -(-max(ng, 1) // fan)
        self.clone = kind == K.KIND_CLONE
        self.armed_policy = (kind in (K.KIND_CLONE, K.KIND_RELAUNCH)
                             and self.thr < INF)
        self.do_resolve = bool(resolve) and self.armed_policy
        self.fr = np.where(np.arange(gp) < ng, F32(0), INF).astype(F32)
        self.dn = np.zeros(gp, F32)
        self.tt = np.full(gp, INF, F32)
        self.ax = np.full(gp, INF, F32)
        self.jb = np.full(gp, INT_MAX, np.int64)
        self.recomputes = 0
        self._build()

    # -- keys of sets and nodes -------------------------------------------
    def _set_free(self, s):
        # a set past ng holds +inf and is never written: it loses every tie
        return (fkey(self.fr[s]), s)

    def _set_trig(self, s):
        base = self.ax[s] if self.clone else self.tt[s]
        if base < INF:  # a set past ng is never armed
            eff = self.dn[s] if self.dn[s] < self.tt[s] else self.tt[s]
            return (fkey(eff), int(self.jb[s]), s)
        return (fkey(INF), NONE, s)

    def _sets(self, q):
        return range(q * self.fan, (q + 1) * self.fan)

    def _build(self):
        self.fnode = [_top2([self._set_free(s) for s in self._sets(q)])
                      for q in range(self.n_nodes)]
        self.tnode = [min(self._set_trig(s) for s in self._sets(q))
                      for q in range(self.n_nodes)]
        self.froot = _top2([p for n in self.fnode for p in n])
        self.troot = min(self.tnode)

    def _walk(self, free_sets, trig_set=None):
        """Re-reduce the changed nodes from their sets; the root from the
        other nodes and the changed nodes' sets."""
        fq = sorted({s // self.fan for s in free_sets})
        if fq:
            kids = [self._set_free(s) for q in fq for s in self._sets(q)]
            for q in fq:
                self.fnode[q] = _top2(
                    [self._set_free(s) for s in self._sets(q)])
            kept = [p for q, n in enumerate(self.fnode) if q not in fq
                    for p in n]
            self.froot = _top2(kept + kids)
        if trig_set is not None:
            q = trig_set // self.fan
            kids = [self._set_trig(s) for s in self._sets(q)]
            self.tnode[q] = min(kids)
            self.troot = min([n for p, n in enumerate(self.tnode) if p != q]
                             + kids)

    # -- the scan --------------------------------------------------------
    def run(self):
        n_jobs = len(self.arr)
        out = np.zeros(n_jobs, F32)
        extra = 0
        if self.ng == 0:  # no set: every job starts at inf, never fires
            for i in range(n_jobs):
                a = self.arr[i]
                d0 = F32((INF if INF > a else a) + self.svc[i, 0])
                out[i] = F32(0) if self.armed_policy else F32(d0 - a)
            return out, extra
        m_hw = F32(-np.inf)
        park = None
        thr = self.thr

        def resolve(limit):
            nonlocal extra, m_hw, park
            if park is not None:
                self.ax[park[0]] = park[1]
                park = None
            while True:
                m = kval(self.froot[0][0])
                if self.clone:
                    if m < m_hw:
                        self.recomputes += 1
                        for k in range(self.ng):
                            t = self.ax[k]
                            if t < INF:
                                while t < self.dn[k] and t < m:
                                    t = F32(t + thr)
                                self.tt[k] = t
                        self._build()
                        m_hw = m
                    while kval(self.troot[0]) < INF:
                        r = self.troot[2]
                        t, d = self.tt[r], self.dn[r]
                        if not (t < d and t < m):
                            break
                        while t < d and t < m:
                            t = F32(t + thr)
                        self.tt[r] = t
                        m_hw = max(m_hw, m)
                        self._walk([], r)
                key, jid, g = self.troot
                if not kval(key) < INF:
                    return  # nothing armed
                d = self.dn[g]
                t = d if d < self.tt[g] else self.tt[g]
                disarm = t >= d
                start = m if m > limit else limit
                if not (t < start or (t <= start and disarm)):
                    return
                h = -1
                if disarm:
                    done = d
                elif self.clone:
                    h = self.froot[0][1]
                    cand = F32(t + self.alt[jid, h])
                    done = cand if cand < d else d
                else:
                    done = F32(t + self.ax[g])
                moved = (np.asarray(self.fr[g]).view(np.uint32)
                         != np.asarray(done, F32).view(np.uint32))
                self.fr[g] = done
                if h >= 0:
                    self.fr[h] = done
                self.dn[g] = done
                self.tt[g] = INF
                self.ax[g] = INF
                self._walk([g, h] if h >= 0 else [g] if moved else [], g)
                out[jid] = F32(done - self.arr[jid])
                extra += 0 if disarm else 1

        for i in range(n_jobs):
            a = self.arr[i]
            if self.do_resolve:
                resolve(a)
            (k1, g), (k2, ri) = self.froot  # ri: the runner-up of g
            m, f2 = kval(k1), kval(k2)
            start = m if m > a else a
            d0 = F32(start + self.svc[i, g])
            d_final = d0
            h = -1
            if (self.kind == K.KIND_HEDGED and self.hmask[i] and ri < self.ng
                    and f2 <= start):
                h = ri
                cand = F32(start + self.alt[i, h])
                d_final = cand if cand < d0 else d0
            d_primary = d0 if self.armed_policy else d_final
            self.fr[g] = d_primary
            self.dn[g] = d_primary
            if h >= 0:
                self.fr[h] = d_final
            if not self.armed_policy:
                out[i] = F32(d_final - a)
            extra += h >= 0
            if self.armed_policy:
                tr = F32(start + thr)
                if self.kind == K.KIND_RELAUNCH and self.do_resolve:
                    if park is not None:
                        self.ax[park[0]] = park[1]
                    park = (g, self.alt[i, g])
                self.tt[g] = tr
                if self.clone:
                    self.ax[g] = tr
                self.jb[g] = i
            self._walk([g] if h < 0 else [g, h],
                       g if self.do_resolve else None)
        if self.do_resolve:
            resolve(INF)
        return out, extra


def _keys(x):
    """``fkey`` of every float32 of an array, as uint32."""
    b = np.asarray(x, F32).view(np.uint32)
    b = np.where((b << np.uint32(1)) == 0, np.uint32(0), b)
    return np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))


def merge2(x, y):
    """The kernel's merge of two lowest-two pairs, each sorted."""
    (xa, xb), (ya, yb) = x, y
    lo, hi = (ya, xa) if ya < xa else (xa, ya)
    l2 = yb if yb < xb else xb
    return (lo, l2 if l2 < hi else hi)


def warp_top2(v):
    """The kernel's warp_top2 over every lane's (a, b): the least key, the
    least index holding it, then the same over every lane's best but the
    winner's, which offers its second."""
    ka = min(a[0] for a, _ in v)
    ia = min(a[1] for a, _ in v if a[0] == ka)
    c = [b if a == (ka, ia) else a for a, b in v]
    kb = min(k for k, _ in c)
    return ((ka, ia), (kb, min(i for k, i in c if k == kb)))


NONE2 = ((KNONE, INT_MAX), (KNONE, INT_MAX))
NONE3 = (KNONE, NONE, INT_MAX)


class WideTreeScan(TreeScan):
    """One program of the unstaged instantiation (``sojourn_cells_kernel_
    wide``): the sets' state as :class:`TreeScan` keeps it (the kernel's
    device-memory scratch), the node level as the kernel's shared table.

    A node of ``fan`` sets is ``lanes`` lanes of ``fan // lanes`` sets
    (32 of four in the kernel).  Lane l keeps nodes l * slots + s, slots =
    ceil(nodes / lanes) from the program's own ``n_groups``, in table
    entry ``[s][l]``, and reads and writes only those.  A walk re-reduces
    a changed node from its sets (each lane its own, then across lanes)
    and the root across lanes from each lane's merge of its kept entries
    but the changed nodes', with the changed nodes' sets of that lane; a
    program of one node takes the node as the root.  Table entries past
    the program's nodes stay empty.
    """

    def __init__(self, *a, lanes=32, **kw):
        self.lanes = lanes
        super().__init__(*a, **kw)

    def _lane_free(self, q):
        """Each lane's lowest two free (key, index) of node q's sets."""
        per = self.fan // self.lanes
        base = q * self.fan
        keys = _keys(self.fr[base:base + self.fan]).astype(np.int64)
        out = []
        for lane in range(self.lanes):
            pairs = sorted((int(keys[lane * per + j]), base + lane * per + j)
                           for j in range(per))
            out.append(_top2(pairs))
        return out

    def _lane_trig(self, q):
        per = self.fan // self.lanes
        return [min(self._set_trig(q * self.fan + lane * per + j)
                    for j in range(per)) for lane in range(self.lanes)]

    def _kept(self, lane, table, none, pick, skip):
        r = none
        for s in range(self.slots):
            q = lane * self.slots + s
            keep = q < self.n_nodes and q not in skip
            r = pick(r, table[s][lane] if keep else none)
        return r

    def _store(self, table, q, entry):
        table[q % self.slots][q // self.slots] = entry

    def _build(self):
        self.slots = -(-self.n_nodes // self.lanes)
        self.ftab = [[NONE2] * self.lanes for _ in range(self.slots)]
        self.ttab = [[NONE3] * self.lanes for _ in range(self.slots)]
        for q in range(self.n_nodes):
            self._store(self.ftab, q, warp_top2(self._lane_free(q)))
            self._store(self.ttab, q, min(self._lane_trig(q)))
        self.froot = warp_top2([self._kept(lane, self.ftab, NONE2, merge2, ())
                                for lane in range(self.lanes)])
        self.troot = min(self._kept(lane, self.ttab, NONE3, min, ())
                         for lane in range(self.lanes))

    def _walk(self, free_sets, trig_set=None):
        fq = sorted({s // self.fan for s in free_sets})
        if fq:
            kids = [self._lane_free(q) for q in fq]
            nodes = [warp_top2(k) for k in kids]
            if self.n_nodes == 1:
                self.froot = nodes[0]
            else:
                rc = []
                for lane in range(self.lanes):
                    r = self._kept(lane, self.ftab, NONE2, merge2, fq)
                    for k in kids:
                        r = merge2(r, k[lane])
                    rc.append(r)
                self.froot = warp_top2(rc)
            for q, n in zip(fq, nodes):
                self._store(self.ftab, q, n)
        if trig_set is not None:
            q = trig_set // self.fan
            kids = self._lane_trig(q)
            node = min(kids)
            self.troot = node if self.n_nodes == 1 else min(
                min(self._kept(lane, self.ttab, NONE3, min, (q,)), kids[lane])
                for lane in range(self.lanes))
            self._store(self.ttab, q, node)


# the H100's staged limit: 20 bytes a set, whole nodes of 128, in 227 KB
# of shared memory a block less the 128-byte prefetch ring
STAGED_MAX = (232_448 - 128) // (20 * 128) * 128


def tree_cells(arr, svc, alt, kinds, thr, hm, ng, resolve, fan=128,
               wide=False, lanes=32):
    """Every (cell, policy) program of one launch: (out, extra, recomputes).
    ``wide``: the unstaged instantiation's layout (:class:`WideTreeScan`
    with ``lanes`` lanes a node)."""
    n_cells, n_jobs, _ = svc.shape
    out = np.zeros((n_cells, len(kinds), n_jobs), F32)
    extra = np.zeros((n_cells, len(kinds)), np.int64)
    recomputes = 0
    kw = {"lanes": lanes} if wide else {}
    for c in range(n_cells):
        for p, kind in enumerate(kinds):
            prog = (WideTreeScan if wide else TreeScan)(
                arr, svc[c], alt[c], int(kind), thr[c, p], hm[p], int(ng[c]),
                resolve, fan, **kw)
            out[c, p], extra[c, p] = prog.run()
            recomputes += prog.recomputes
    return out, extra, recomputes


def _cells(seed, n_cells, n_jobs, n_g, ties, finite, negative=False):
    """A launch's inputs: cells of mixed n_groups padded to n_g."""
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
    if negative:
        svc = svc - 0.9
        alt = alt - 0.9
    kinds = np.array([0, 1, 2, 3], np.int32)
    thr = np.full((n_cells, 4), np.inf)
    if finite:
        thr[:, 1] = 1.0 if ties else np.quantile(svc, 0.7)
        thr[:, 2] = 1.5 if ties else np.quantile(svc, 0.85)
        if negative:
            thr[:, 1:3] = 0.4
    hm = np.stack([O.hedge_mask(n_jobs, f) for f in (0, 0, 0, 0.5)])
    ng = np.maximum(1, (np.arange(n_cells) + 1) * n_g // n_cells)
    return (arr.astype(F32), svc.astype(F32), alt.astype(F32), kinds,
            thr.astype(F32), hm, ng.astype(np.int32))


def _check(args, fan=128, wide=False, lanes=32):
    """Emulation == ref.py == the plain version, bit for bit (ref.py on
    the cells of at least one replica set: it has no answer for none)."""
    arr, svc, alt, kinds, thr, hm, ng = args
    resolve = O.needs_resolve(kinds, thr)
    out_t, x_t, recomputes = tree_cells(*args, resolve, fan, wide, lanes)
    some = ng > 0
    out_r, x_r = sojourn_cells_reference(arr, svc[some], alt[some], kinds,
                                         thr[some], hm, ng[some])
    np.testing.assert_array_equal(out_t[some], out_r)
    np.testing.assert_array_equal(x_t[some], x_r)
    tens = [torch.as_tensor(np.ascontiguousarray(a)) for a in args]
    tens[3] = tens[3].to(torch.int32)
    out_p, x_p = K.sojourn_cells_plain(*tens, resolve=resolve)
    np.testing.assert_array_equal(out_t, out_p.numpy())
    np.testing.assert_array_equal(x_t, x_p.numpy())
    return recomputes


@pytest.mark.parametrize("n_g", GROUPS)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("finite", [True, False])
def test_tree_scan_matches_reference(n_g, ties, finite):
    """All four kinds, three cells of mixed n_groups in one launch."""
    n_jobs = 40 if n_g >= 257 else 60
    _check(_cells(n_g, 3, n_jobs, n_g, ties, finite))


@pytest.mark.parametrize("n_g", [5, 17, 33, 70])
@pytest.mark.parametrize("ties", [False, True])
def test_small_nodes_match_reference(n_g, ties):
    """Nodes of four sets give two to eighteen nodes at a few dozen sets,
    so walks whose changed sets share a node, span two nodes, or leave
    the root in another node all occur."""
    _check(_cells(100 + n_g, 3, 60, n_g, ties, True), fan=4)


@pytest.mark.parametrize("fan", [4, 128])
def test_negative_draws_take_the_exact_clone_path(fan):
    """Negative service draws can lower min(free) in a clone program; the
    kernel then recomputes every clone trigger from its base time."""
    args = _cells(7, 2, 80, 9, False, True, negative=True)
    assert _check(args, fan) > 0


def test_cell_without_sets_matches_plain():
    """A cell of no replica set (``ref.py`` has no answer for it): every
    job starts at inf, as the plain version computes it."""
    arr, svc, alt, kinds, thr, hm, _ = _cells(3, 2, 20, 5, False, True)
    ng = np.array([0, 5], np.int32)
    resolve = O.needs_resolve(kinds, thr)
    out_t, x_t, _ = tree_cells(arr, svc, alt, kinds, thr, hm, ng, resolve)
    tens = [torch.as_tensor(np.ascontiguousarray(a))
            for a in (arr, svc, alt, kinds, thr, hm, ng)]
    out_p, x_p = K.sojourn_cells_plain(*tens, resolve=resolve)
    np.testing.assert_array_equal(out_t, out_p.numpy())
    np.testing.assert_array_equal(x_t, x_p.numpy())


@given(seed=st.integers(0, 2**31 - 1), n_g=st.sampled_from(GROUPS[:7]),
       ties=st.booleans())
@settings(max_examples=12, deadline=None)
def test_tree_scan_matches_reference_at_random_seeds(seed, n_g, ties):
    _check(_cells(seed, 2, 30, n_g, ties, True))


def test_kernel_layout_covers_the_largest_grid():
    """The kernel keeps 20 bytes a set, rounded up to nodes of 128, in one
    block's shared memory (227 KB on the H100, less its 128-byte prefetch
    ring), and at most 96 nodes in lane registers: 10,000 sets, the sweep
    benchmark's N at r = 1, must fit both."""
    slots = -(-10_000 // 128) * 128
    assert 20 * slots <= 232_448 - 128 and slots // 128 <= 96


# the unstaged instantiation's widths: the staged limit and one past it,
# the last and first widths of 3 and 4 nodes a lane, the wide
# fleet's r = 1 and 65,536 sets (16 table entries a lane)
WIDE_GROUPS = [11_520, 11_521, 12_288, 12_289, 16_384, 65_536]
WIDE_CASES = {"draws": (False, True, False), "ties": (True, True, False),
              "infinite": (False, False, False),
              "negative": (False, True, True)}


@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("n_g", WIDE_GROUPS)
def test_wide_layout_matches_reference(n_g, case):
    """All four kinds, two cells (n_g // 2 and n_g sets) padded to n_g, in
    the layout the kernel's launch picks at n_g: staged up to the H100's
    11,520, the unstaged table above; finite and infinite thresholds,
    forced ties, and negative draws (which lower m and make clone programs
    recompute their triggers; m rises, and so can fall, only once the jobs
    outnumber the sets, so there the first cell has 9)."""
    ties, finite, negative = WIDE_CASES[case]
    args = _cells(n_g + len(case), 2, 64, n_g, ties, finite, negative)
    if negative:
        args[6][0] = 9
    recomputes = _check(args, wide=n_g > STAGED_MAX)
    if negative:
        assert recomputes > 0


@pytest.mark.parametrize("ties,finite", [(False, True), (True, False)])
def test_wide_layout_mixed_launch(ties, finite):
    """One launch of cells of 0, 1, 11,520, 11,521 and 16,384 sets padded
    to 16,384: each program reads its own n_groups, keeps its own number
    of nodes a lane, and the cell of none gives the plain version's
    answer."""
    arr, svc, alt, kinds, thr, hm, _ = _cells(29 + ties, 5, 64, 16_384, ties,
                                              finite)
    ng = np.array([0, 1, 11_520, 11_521, 16_384], np.int32)
    _check((arr, svc, alt, kinds, thr, hm, ng), wide=True)


@pytest.mark.parametrize("n_g", [5, 17, 70, 257])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_layout_small_nodes_match_reference(n_g, ties):
    """The unstaged table at nodes of four sets, one a lane over four
    lanes: up to 17 nodes a lane, and 200 jobs, more than the sets, so
    every lane's entries win the root, lose it and are rewritten."""
    _check(_cells(300 + n_g, 3, 200, n_g, ties, True), fan=4, wide=True,
           lanes=4)


def test_wide_layout_small_nodes_take_the_exact_clone_path():
    """Negative draws in the unstaged table: 33 sets, nine nodes of four,
    three a lane."""
    args = _cells(2, 2, 150, 33, False, True, negative=True)
    assert _check(args, fan=4, wide=True, lanes=4) > 0


def test_wide_layout_covers_65536_sets():
    """The unstaged instantiation keeps each program's 20 bytes a set in
    device memory and its node table (16 nodes a lane of 28 bytes at
    65,536 sets: 14,336 bytes) in one block's shared memory beside the
    prefetch ring; 65,536 sets are 512 nodes, and the table's limit lies
    far past them."""
    nodes = 65_536 // 128
    slots = -(-nodes // 32)
    assert slots == 16 and 32 * slots * 28 == 14_336
    assert 32 * slots * 28 <= 232_448 - 128
    room_slots = (232_448 - 128) // (32 * 28)
    assert room_slots * 32 * 128 == 1_060_864 >= 65_536
    assert 16 * 20 * 16_384 == 5_242_880  # the wide fleet's 16 programs


def test_policy_sweep_is_one_call_and_equals_the_reference(monkeypatch):
    """``sweep_sojourn_policies`` sends every (dist, split, policy) program
    through one ``sojourn_cells`` call and still equals the reference's
    ``pallas`` lane at ``tests/test_torch_simulator.py``'s seeds."""
    calls = []
    orig = K.sojourn_cells

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(K, "sojourn_cells", counted)
    r_dists = [RSExp(0.05, 2.0),
               REmp(np.random.default_rng(5).gamma(2.0, 0.5, 300))]
    r_pols = (RPol("none"), RPol("clone", quantile=0.85),
              RPol("relaunch", quantile=0.9),
              RPol("hedged", hedge_fraction=0.3))
    for seed in (3, 4):
        kw = dict(arrival_rate=4.0, n_jobs=400, seed=seed,
                  feasible_b=[2, 4, 8])
        ref = RS.sweep_sojourn_policies(r_dists, 16, policies=r_pols,
                                        backend="pallas", **kw)
        calls.clear()
        port = TS.sweep_sojourn_policies(
            from_reference(r_dists), 16, policies=from_reference(r_pols),
            device="cpu", **kw)
        assert calls == [(6, 400, 8)]
        np.testing.assert_array_equal(port.samples, ref.samples)
        np.testing.assert_array_equal(port.extra_fraction, ref.extra_fraction)
