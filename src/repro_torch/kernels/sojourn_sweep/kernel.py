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

__all__ = [
    "KIND_NONE",
    "KIND_CLONE",
    "KIND_RELAUNCH",
    "KIND_HEDGED",
    "sojourn_cells",
    "sojourn_cells_plain",
    "coded_cells",
    "coded_cells_plain",
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
    """Largest G whose per-set state fits the card's shared memory."""
    return int(_build.load("sojourn_cells").sojourn_cells_max_groups())


def sojourn_cells(arrivals, svc, alt, kinds, thresholds, hedge_masks,
                  n_groups, resolve: bool = True):
    """All (cell, policy) sojourn scans: ``(out (C,P,J) f32, extra (C,P) i32)``.

    Inputs: ``arrivals`` (J,) float32; ``svc``/``alt`` (C,J,G) float32;
    ``kinds`` (P,) int32; ``thresholds`` (C,P) float32; ``hedge_masks``
    (P,J) bool; ``n_groups`` (C,) int32; all on one device and contiguous.
    ``resolve=False`` skips the event-resolution pass (valid only when no
    lane can arm a trigger).  A CPU tensor runs :func:`sojourn_cells_plain`.
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
    if not 1 <= n_g <= _max_groups():
        raise ValueError(
            f"G={n_g} replica sets: the kernel's shared-memory state holds "
            f"1 to {_max_groups()}")
    out = torch.empty((n_cells, n_pol, n_jobs), dtype=f32, device=dev)
    extra = torch.empty((n_cells, n_pol), dtype=torch.int32, device=dev)
    if n_cells * n_pol == 0 or n_jobs == 0:
        extra.zero_()
        return out, extra
    code = lib.sojourn_cells_launch(
        _ptr(arrivals), _ptr(svc), _ptr(alt), _ptr(kinds), _ptr(thresholds),
        _ptr(hedge_masks.view(torch.uint8)), _ptr(n_groups), _ptr(out),
        _ptr(extra), n_cells, n_pol, n_jobs, n_g, int(bool(resolve)), _stream())
    _build.check(lib, code, "sojourn_cells launch")
    _build.count_launch("sojourn_cells")
    return out, extra


def coded_cells(times, ks, force_radix: bool = False):
    """k-th order statistic per (cell, trial): (C,T,N) f32, (C,) i32 -> (C,T).

    ``ks[c]`` must lie in [1, N].  Rows of N <= 64 take the rank-counting
    path unless ``force_radix``, which runs the long-row radix select on
    them too (to time one path against the other).  A CPU tensor runs
    :func:`coded_cells_plain`.
    """
    n_cells, n_trials, n = times.shape
    dev = times.device
    _require(times, "times", torch.float32, (n_cells, n_trials, n), dev)
    _require(ks, "ks", torch.int32, (n_cells,), dev)
    if dev.type == "cpu":
        return coded_cells_plain(times, ks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load("coded_cells")
    out = torch.empty((n_cells, n_trials), dtype=torch.float32, device=dev)
    if n_cells * n_trials == 0:
        return out
    code = lib.coded_cells_launch(_ptr(times), _ptr(ks), _ptr(out), n_cells,
                                  n_trials, n, int(bool(force_radix)),
                                  _stream())
    _build.check(lib, code, "coded_cells launch")
    _build.count_launch("coded_cells")
    return out
