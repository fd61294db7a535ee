"""The sojourn scan and the k-of-N selection: CUDA wrappers and plain twins.

:func:`sojourn_cells` and :func:`coded_cells` take tensors on one device.
On a CUDA tensor they launch the hand-written kernel of
``csrc/sojourn_cells.cu`` / ``csrc/coded_cells.cu`` (or raise); on a CPU
tensor they run the plain PyTorch version beside them.  The plain versions
compute what ``repro.kernels.sojourn_sweep.ref`` computes, batched over
every (cell, policy) lane, in the inputs' float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

KIND_NONE = 0
KIND_CLONE = 1
KIND_RELAUNCH = 2
KIND_HEDGED = 3

_INT_MAX = 2**31 - 1

# csrc/coded_cells.cu: ks in host memory ride in the launch up to this many
# cells; the radix select's digit bits, its most passes, and the most
# candidates that one warp sorts to finish
CODED_HOST_QUORUMS = 64
CODED_RADIX_BITS = 8
CODED_MAX_PASSES = 4
CODED_RANK_MAX = 32

__all__ = [
    "KIND_NONE",
    "KIND_CLONE",
    "KIND_RELAUNCH",
    "KIND_HEDGED",
    "sojourn_cells",
    "sojourn_cells_plain",
    "CODED_HOST_QUORUMS",
    "coded_cells",
    "coded_cells_plain",
    "coded_radix_counts",
    "coded_radix_counts_plain",
]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin with ties to the lowest index (all-inf rows -> 0),
    the tie rule of ``jnp.argmin`` made explicit for every device."""
    n = x.shape[1]
    m = x.amin(dim=1, keepdim=True)
    idx = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == m, idx, n).amin(dim=1)


def sojourn_cells_plain(arrivals, svc, alt, kinds, thresholds, hedge_masks,
                        n_groups, resolve: bool = True):
    """Plain PyTorch sojourn scan over every (cell, policy) lane at once.

    Same contract as :func:`sojourn_cells`.  Lanes are ordered
    ``lane = cell * P + policy``; each step of the Python loop over jobs
    updates every lane, and the event-resolution loop runs until no lane
    fires or disarms (a lane that stopped recomputes the same no-op).
    """
    n_cells, n_jobs, n_g = svc.shape
    n_pol = kinds.shape[0]
    dev = svc.device
    dt = svc.dtype
    n_lanes = n_cells * n_pol
    lane = torch.arange(n_lanes, device=dev)
    cell = lane // n_pol
    kind = kinds.to(torch.int64).repeat(n_cells)
    thr = thresholds.reshape(n_lanes).to(dt)
    hm = hedge_masks.to(torch.bool).repeat(n_cells, 1)
    ng = n_groups.to(torch.int64).repeat_interleave(n_pol)
    gidx = torch.arange(n_g, device=dev)
    valid = gidx[None, :] < ng[:, None]
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    is_clone = kind == KIND_CLONE
    armed_policy = ((kind == KIND_CLONE) | (kind == KIND_RELAUNCH)) & (thr < inf)
    is_hedged = kind == KIND_HEDGED

    free = torch.where(valid, torch.zeros((), dtype=dt, device=dev), inf)
    doneg = torch.zeros((n_lanes, n_g), dtype=dt, device=dev)
    trig = torch.full((n_lanes, n_g), float("inf"), dtype=dt, device=dev)
    jobid = torch.full((n_lanes, n_g), _INT_MAX, dtype=torch.int64, device=dev)
    out = torch.zeros((n_lanes, n_jobs), dtype=dt, device=dev)
    extra = torch.zeros(n_lanes, dtype=torch.int64, device=dev)

    def _resolve(limit):
        while True:
            m = torch.where(valid, free, inf).amin(dim=1)
            armed = trig < inf
            t = trig.clone()
            while True:  # clone re-arm: t += threshold until a set is idle
                cond = armed & (t < doneg) & (t < m[:, None]) & is_clone[:, None]
                if not bool(cond.any()):
                    break
                t = torch.where(cond, t + thr[:, None], t)
            eff = torch.minimum(torch.where(is_clone[:, None], t, trig), doneg)
            eff = torch.where(armed, eff, inf)
            t_min = eff.amin(dim=1)
            masked = torch.where(eff == t_min[:, None], jobid, _INT_MAX)
            g = _argmin_first(masked)
            tt = eff[lane, g]
            jid = jobid[lane, g]
            d = doneg[lane, g]
            disarm = tt >= d
            start = torch.maximum(limit, m)
            do = (t_min < start) | ((t_min <= start) & disarm & (t_min < inf))
            if not bool(do.any()):
                return
            idle = valid & (free <= tt[:, None])
            h = _argmin_first(torch.where(idle, free, inf))
            jid_c = jid.clamp(max=n_jobs - 1)
            alt_h = alt[cell, jid_c, h]
            alt_g = alt[cell, jid_c, g]
            done_fire = torch.where(is_clone, torch.minimum(d, tt + alt_h),
                                    tt + alt_g)
            done_new = torch.where(disarm, d, done_fire)
            clone_set = do & ~disarm & is_clone
            ld, gd, jd = lane[do], g[do], jid[do]
            free[ld, gd] = done_new[do]
            free[lane[clone_set], h[clone_set]] = done_new[clone_set]
            doneg[ld, gd] = done_new[do]
            trig[ld, gd] = inf
            out[ld, jd] = done_new[do] - arrivals[jd]
            extra.add_((do & ~disarm).to(torch.int64))

    for i in range(n_jobs):
        a = arrivals[i]
        if resolve:
            _resolve(a)
        fv = torch.where(valid, free, inf)
        m = fv.amin(dim=1)
        start = torch.maximum(a, m)
        g = _argmin_first(fv)
        d0 = start + svc[cell, i, g]
        idle = valid & (free <= start[:, None]) & (gidx[None, :] != g[:, None])
        h = _argmin_first(torch.where(idle, free, inf))
        do_hedge = is_hedged & hm[:, i] & idle.any(dim=1)
        d_final = torch.where(do_hedge,
                              torch.minimum(d0, start + alt[cell, i, h]), d0)
        d_primary = torch.where(armed_policy, d0, d_final)
        free[lane, g] = d_primary
        free[lane, h] = torch.where(do_hedge, d_final, free[lane, h])
        doneg[lane, g] = d_primary
        trig[lane, g] = torch.where(armed_policy, start + thr, inf)
        jobid[lane, g] = i
        out[:, i] = torch.where(armed_policy, out[:, i], d_final - a)
        extra.add_(do_hedge.to(torch.int64))
    if resolve:
        _resolve(inf)
    return (out.reshape(n_cells, n_pol, n_jobs),
            extra.to(torch.int32).reshape(n_cells, n_pol))


def coded_cells_plain(times, ks):
    """k-th smallest per (cell, trial) row: sort and gather column k-1."""
    srt = torch.sort(times, dim=2).values
    idx = (ks.to(torch.int64) - 1)[:, None, None].expand(-1, times.shape[1], 1)
    return torch.gather(srt, 2, idx)[:, :, 0]


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 key of each float32, as int64."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def coded_radix_counts_plain(times, ks):
    """The radix select's candidates left after each pass: (C,T,P) int32.

    The plain version of :func:`coded_radix_counts`: every row at once, the
    passes of ``csrc/coded_cells.cu``'s long-row path.  A pass takes the
    candidates' range [lo, hi] (at first the row's), counts the 8-bit digit
    ``(key - lo) >> s`` with ``s`` the shift that brings the range under
    256 bins, keeps the bin that holds the k-th, and records how many keys
    it holds; the row is done when its candidates' range is one key, or
    after a pass that left at most 32 (which one warp sorts).  Passes not
    run count 0.
    """
    n_cells, n_trials, n = times.shape
    keys = _order_keys(times).reshape(n_cells * n_trials, n)
    dev = keys.device
    k = ks.to(device=dev, dtype=torch.int64).repeat_interleave(n_trials)
    lo, hi = keys.amin(1), keys.amax(1)
    m = torch.full_like(lo, n)
    live = lo != hi
    inb = torch.ones_like(keys, dtype=torch.bool)
    counts = torch.zeros((keys.shape[0], CODED_MAX_PASSES), dtype=torch.int32,
                         device=dev)
    nb = 1 << CODED_RADIX_BITS
    for p in range(CODED_MAX_PASSES):
        if p:
            live = live & (m > CODED_RANK_MAX)
        if not bool(live.any()):
            break
        # bit length of the span (exact: spans are below 2**32)
        width = torch.frexp((hi - lo).double()).exponent.to(torch.int64)
        s = (width - CODED_RADIX_BITS).clamp(min=0)
        d = torch.where(inb, (keys - lo[:, None]) >> s[:, None], nb)
        hist = torch.zeros((keys.shape[0], nb + 1), dtype=torch.int64,
                           device=dev).scatter_add_(1, d, torch.ones_like(d))
        cum = hist[:, :nb].cumsum(1)
        dig = (cum < k[:, None]).sum(1, keepdim=True).clamp(max=nb - 1)
        cnt = hist.gather(1, dig)[:, 0]
        below = cum.gather(1, dig)[:, 0] - cnt
        k = torch.where(live, k - below, k)
        m = torch.where(live, cnt, m)
        inb = torch.where(live[:, None], inb & (d == dig), inb)
        lo = torch.where(live, torch.where(inb, keys, 1 << 32).amin(1), lo)
        hi = torch.where(live, torch.where(inb, keys, -1).amax(1), hi)
        counts[:, p] = torch.where(live, cnt, 0).to(torch.int32)
        live = live & (lo != hi)
    return counts.reshape(n_cells, n_trials, CODED_MAX_PASSES)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _max_groups() -> int:
    """Largest G of the staged instantiations: the per-set state in one
    block's shared memory."""
    return int(_build.load("sojourn_cells").sojourn_cells_max_groups())


@functools.lru_cache(maxsize=None)
def _max_wide_groups() -> int:
    """Largest G of the unstaged instantiation: its node and group tables
    in one block's shared memory (with no set staged beside them)."""
    return int(_build.load("sojourn_cells").sojourn_cells_max_wide_groups())


@functools.lru_cache(maxsize=None)
def _wide_split(n_g: int) -> tuple[int, int]:
    """The unstaged instantiation's split at G = ``n_g``: the first ``kh``
    sets keep their hot words (free, trigger time, doneg) in shared memory
    beside the tables, the first ``kc`` their cold ones (aux, job id); the
    rest live in the scratch."""
    lib = _build.load("sojourn_cells")
    kh, kc = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.sojourn_cells_wide_split(n_g, ctypes.byref(kh),
                                                   ctypes.byref(kc)),
                 "sojourn_cells_wide_split")
    return kh.value, kc.value


def sojourn_cells(arrivals, svc, alt, kinds, thresholds, hedge_masks,
                  n_groups, resolve: bool = True, force_wide: bool = False):
    """All (cell, policy) sojourn scans: ``(out (C,P,J) f32, extra (C,P) i32)``.

    Inputs: ``arrivals`` (J,) float32; ``svc``/``alt`` (C,J,G) float32;
    ``kinds`` (P,) int32; ``thresholds`` (C,P) float32; ``hedge_masks``
    (P,J) bool; ``n_groups`` (C,) int32; all on one device and contiguous.
    ``resolve=False`` skips the event-resolution pass (valid only when no
    lane can arm a trigger).  On the card, G up to :func:`_max_groups`
    runs the staged kernel (the sets' state in shared memory) and a wider
    G the unstaged one (node and group tables and the first sets' state in
    shared memory, :func:`_wide_split`; the other sets' state in a
    device-memory scratch allocated here); ``force_wide`` runs the
    unstaged one at any G (to hold the two against each other on the same
    input).  A CPU tensor runs :func:`sojourn_cells_plain`.
    """
    n_cells, n_jobs, n_g = svc.shape
    n_pol = kinds.shape[0]
    dev = svc.device
    f32 = torch.float32
    _require(arrivals, "arrivals", f32, (n_jobs,), dev)
    _require(svc, "svc", f32, (n_cells, n_jobs, n_g), dev)
    _require(alt, "alt", f32, (n_cells, n_jobs, n_g), dev)
    _require(kinds, "kinds", torch.int32, (n_pol,), dev)
    _require(thresholds, "thresholds", f32, (n_cells, n_pol), dev)
    _require(hedge_masks, "hedge_masks", torch.bool, (n_pol, n_jobs), dev)
    _require(n_groups, "n_groups", torch.int32, (n_cells,), dev)
    if dev.type == "cpu":
        return sojourn_cells_plain(arrivals, svc, alt, kinds, thresholds,
                                   hedge_masks, n_groups, resolve=resolve)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load("sojourn_cells")
    if n_g < 1:
        raise ValueError(f"G={n_g} replica sets: the kernel needs at least 1")
    wide = force_wide or n_g > _max_groups()
    if wide and n_g > _max_wide_groups():
        raise ValueError(
            f"G={n_g} replica sets: the kernel's tree tables (32 bytes a "
            f"node of 128 sets, and its groups of 32 nodes) do not fit one "
            f"block's shared memory on "
            f"{torch.cuda.get_device_name(dev)}, which holds them for up to "
            f"{_max_wide_groups()}")
    out = torch.empty((n_cells, n_pol, n_jobs), dtype=f32, device=dev)
    extra = torch.empty((n_cells, n_pol), dtype=torch.int32, device=dev)
    if n_cells * n_pol == 0 or n_jobs == 0:
        extra.zero_()
        return out, extra
    args = (_ptr(arrivals), _ptr(svc), _ptr(alt), _ptr(kinds),
            _ptr(thresholds), _ptr(hedge_masks.view(torch.uint8)),
            _ptr(n_groups), _ptr(out), _ptr(extra))
    if wide:
        # each program's set state past the split, on the launch's stream
        # (an allocation the card cannot hold raises here)
        kh, kc = _wide_split(n_g)
        state = torch.empty(
            n_cells * n_pol * lib.sojourn_cells_state_words(n_g, kh, kc),
            dtype=f32, device=dev)
        code = lib.sojourn_cells_wide_launch(
            *args, _ptr(state), n_cells, n_pol, n_jobs, n_g,
            int(bool(resolve)), kh, kc, _stream())
    else:
        code = lib.sojourn_cells_launch(
            *args, n_cells, n_pol, n_jobs, n_g, int(bool(resolve)), _stream())
    _build.check(lib, code, "sojourn_cells launch")
    _build.count_launch("sojourn_cells")
    return out, extra


def _coded_reject(times, ks) -> None:
    """Raise the error that the fast checks of :func:`coded_cells` saw."""
    if times.dim() != 3:
        raise ValueError(f"times must be (C, T, N), got {tuple(times.shape)}")
    n_cells, n_trials, n = times.shape
    dev = times.device
    _require(times, "times", torch.float32, (n_cells, n_trials, n), dev)
    host_ks = dev.type == "cuda" and ks.device.type == "cpu"
    _require(ks, "ks", torch.int32, (n_cells,), ks.device if host_ks else dev)
    if host_ks and n_cells > CODED_HOST_QUORUMS:
        raise ValueError(f"ks in host memory: at most {CODED_HOST_QUORUMS} "
                         f"cells, got {n_cells}; put ks on {dev}")
    raise ValueError(f"ks on {ks.device} cannot go with times on {dev}")


def _coded_launch(times, ks, force_radix: bool, counts=None):
    """Launch ``csrc/coded_cells.cu`` on CUDA ``times``; returns ``out``."""
    n_cells, n_trials, n = times.shape
    lib = _build.load("coded_cells")
    out = times.new_empty((n_cells, n_trials))
    if n_cells * n_trials == 0:
        return out
    # plain ints: the declared argtypes make them pointers; the stream is
    # PyTorch's current one as a raw handle (see ``combine``)
    on_host = not ks.is_cuda
    code = lib.coded_cells_launch(
        times.data_ptr(), None if on_host else ks.data_ptr(),
        ks.data_ptr() if on_host else None, out.data_ptr(),
        None if counts is None else counts.data_ptr(), n_cells, n_trials, n,
        int(force_radix), torch._C._cuda_getCurrentRawStream(times.get_device()))
    if code:
        _build.check(lib, code, "coded_cells launch")
    _build.count_launch("coded_cells")
    return out


def _coded_check(times, ks) -> None:
    """The inputs' checks, as cheap as they can be: at the planner's shape
    a call's host time, not the kernel, sets its wall time."""
    n_cells = times.shape[0] if times.dim() == 3 else -1
    if (n_cells < 0 or times.dtype != torch.float32
            or ks.dtype != torch.int32 or not times.is_contiguous()
            or not ks.is_contiguous() or ks.shape != (n_cells,)
            or (ks.device != times.device
                and not (times.is_cuda and ks.device.type == "cpu"
                         and n_cells <= CODED_HOST_QUORUMS))):
        _coded_reject(times, ks)


def coded_cells(times, ks, force_radix: bool = False):
    """k-th order statistic per (cell, trial): (C,T,N) f32, (C,) i32 -> (C,T).

    ``ks[c]`` must lie in [1, N].  ``ks`` lies on ``times``' device, or, for
    a CUDA ``times`` of at most :data:`CODED_HOST_QUORUMS` cells, in host
    memory: then the launch carries it by value and nothing is copied to
    the card.  Rows of N <= 64 take the short-row path (a sub-group of
    lanes a row) unless ``force_radix``, which runs the long-row radix
    select on them too (to hold one path against the other).  A CPU tensor
    runs :func:`coded_cells_plain`.
    """
    _coded_check(times, ks)
    if not times.is_cuda:
        if times.device.type == "cpu":
            return coded_cells_plain(times, ks)
        raise ValueError(f"unsupported device {times.device}")
    return _coded_launch(times, ks, force_radix)


def coded_radix_counts(times, ks):
    """``(coded_cells(times, ks, force_radix=True), counts (C,T,P) int32)``:
    the k-th values and, per row, the candidates that the radix select left
    after each of its passes, which the kernel records as it runs (0 for
    passes not run).  A CPU tensor runs :func:`coded_cells_plain` and
    :func:`coded_radix_counts_plain`."""
    _coded_check(times, ks)
    if not times.is_cuda:
        if times.device.type == "cpu":
            return coded_cells_plain(times, ks), coded_radix_counts_plain(
                times, ks)
        raise ValueError(f"unsupported device {times.device}")
    counts = torch.empty(tuple(times.shape[:2]) + (CODED_MAX_PASSES,),
                         dtype=torch.int32, device=times.device)
    return _coded_launch(times, ks, True, counts), counts
