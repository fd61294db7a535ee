"""The seam the simulator sweeps call for the sojourn and coded cells.

:func:`sojourn_policy_cells` takes the materialized per-cell service
tensors on one device and evaluates every (cell, policy) pair through
:func:`~.kernel.sojourn_cells`; :func:`coded_completion_cells` does the
same for the k-of-N coded cells through :func:`~.kernel.coded_cells`.
Both cast to the kernels' float32 lane at this boundary, as the
reference's ``jax``/``pallas`` lanes do with ``jax_enable_x64`` off.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel as _kernel
from .kernel import KIND_CLONE, KIND_HEDGED, KIND_NONE, KIND_RELAUNCH

__all__ = [
    "KIND_NONE",
    "KIND_CLONE",
    "KIND_RELAUNCH",
    "KIND_HEDGED",
    "policy_kind_code",
    "hedge_mask",
    "needs_resolve",
    "sojourn_policy_cells",
    "coded_completion_cells",
]

_KIND_CODES = {
    "none": KIND_NONE,
    "clone": KIND_CLONE,
    "relaunch": KIND_RELAUNCH,
    "hedged": KIND_HEDGED,
}


def policy_kind_code(kind: str) -> int:
    """Integer kernel code for a `PolicyCandidate.kind` string."""
    try:
        return _KIND_CODES[kind]
    except KeyError:
        raise ValueError(f"unknown policy kind {kind!r} "
                         f"(expected one of {sorted(_KIND_CODES)})") from None


def hedge_mask(n_jobs: int, fraction: float) -> np.ndarray:
    """Deterministic-stride hedge mask: job i hedges iff
    ``floor((i+1)f) > floor(if)``, evaluated in f64 on the host so every
    device sees the identical pattern regardless of its precision."""
    i = np.arange(n_jobs, dtype=np.float64)
    f = float(fraction)
    return np.floor((i + 1.0) * f) > np.floor(i * f)


def needs_resolve(kinds, thresholds) -> bool:
    """The static specialization: False when no lane can arm a trigger
    (no clone/relaunch policy with a finite threshold), so the scan may
    skip the event-resolution pass, which is then an identity."""
    kinds = torch.as_tensor(kinds)
    thresholds = torch.as_tensor(thresholds)
    trigger = (kinds == KIND_CLONE) | (kinds == KIND_RELAUNCH)
    return bool((trigger[None, :].to(thresholds.device)
                 & torch.isfinite(thresholds)).any())


def _on(x, device, dtype) -> torch.Tensor:
    """``x`` (tensor or array-like) as a contiguous ``dtype`` tensor on
    ``device``; float casts round to nearest."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


def _f32(x, device) -> torch.Tensor:
    return _on(x, device, torch.float32)


def sojourn_policy_cells(arrivals, svc, alt, kinds, thresholds, hedge_masks,
                         n_groups, devices=None):
    """Evaluate all (cell, policy) sojourn recursions on ``svc``'s device,
    or split over ``devices``.

    Parameters
    ----------
    arrivals : (J,) arrival times shared by every cell.
    svc, alt : (C, J, G) primary / redundant service draws per cell,
        group-minimized and load-scaled, as float tensors on the device;
        padded columns beyond ``n_groups[c]`` are never read.
    kinds : (P,) int policy codes (see :func:`policy_kind_code`).
    thresholds : (C, P) trigger delays (``inf`` disables arming).
    hedge_masks : (P, J) bool stride masks (see :func:`hedge_mask`).
    n_groups : (C,) live group count per cell.
    devices : optional list of devices (e.g. every visible card); the cell
        axis is split into ``len(devices)`` consecutive parts of
        ``ceil(C / len(devices))`` cells, part i evaluated on
        ``devices[i]`` by one launch, and the parts concatenated in order
        on ``svc``'s device (the reference's ``cells`` mesh).  Every cell's
        scan reads only its own cell, so the split result equals the
        one-device result bit for bit.

    Returns ``(sojourns (C, P, J) float32, extras (C, P) int32)`` on the
    device.  Float inputs are cast to float32 here (round to nearest).
    """
    dev = svc.device
    kinds = _on(kinds, dev, torch.int32)
    thresholds = _f32(thresholds, dev)
    resolve = needs_resolve(kinds, thresholds)
    if devices is None or len(devices) <= 1:
        parts = [(dev, slice(None))]
    else:
        step = -(-svc.shape[0] // len(devices))
        parts = [(torch.device(d), slice(i * step, (i + 1) * step))
                 for i, d in enumerate(devices)
                 if i * step < svc.shape[0]]
    outs = [
        _kernel.sojourn_cells(
            _f32(arrivals, d),
            _f32(svc[cut], d),
            _f32(alt[cut], d),
            _on(kinds, d, torch.int32),
            _f32(thresholds[cut], d),
            _on(hedge_masks, d, torch.bool),
            _on(torch.as_tensor(n_groups)[cut], d, torch.int32),
            resolve=resolve,
        )
        for d, cut in parts
    ]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o.to(dev) for o, _ in outs]),
            torch.cat([x.to(dev) for _, x in outs]))


def coded_completion_cells(times, ks):
    """k-of-N completion for a batch of coded cells on ``times``' device.

    ``times`` (C, T, N) holds the per-cell load-scaled worker draws,
    ``ks`` (C,) the completion quorums; the result (C, T) float32 is the
    k-th order statistic per trial.  Selection is value-exact.  ``ks``
    stays in host memory where the launch can carry it by value (at most
    ``CODED_HOST_QUORUMS`` cells), so no copy to the card waits on the host.
    """
    times = _f32(times, times.device)
    n_cells, _, n_workers = times.shape
    ks_np = np.asarray(ks, dtype=np.int64)
    if ks_np.shape != (n_cells,):
        raise ValueError(f"ks shape {ks_np.shape} != ({n_cells},)")
    if np.any(ks_np < 1) or np.any(ks_np > n_workers):
        raise ValueError(f"ks must be in [1, N={n_workers}], got {ks_np}")
    ks_t = torch.from_numpy(ks_np.astype(np.int32))
    if n_cells > _kernel.CODED_HOST_QUORUMS:
        ks_t = ks_t.to(times.device)
    return _kernel.coded_cells(times, ks_t)
