"""Carry the reference's objects across into the port.

:func:`from_reference` turns an object of the JAX package — given as its
plain fields, read by attribute name — into the port's object of the same
name: service distributions (``Exponential``, ``ShiftedExponential``,
``Empirical`` with its atoms and weights exactly as stored), the
candidates (``PolicyCandidate``, ``CodingCandidate``, ``SloClass``,
``ShedPolicy``), ``ClusterSpec``, ``Objective``, the placements
(``Assignment``, ``ReplicationPlan``), the telemetry's ``FaultEvent`` and
the tuner's ``TunerConfig`` (whose sweep engine is not carried: the
port's ``device`` keeps its default).  Tuples and lists are converted
entry by entry; ``None``, plain numbers and frozensets pass through.

:func:`params_from_reference` turns the reference's LM parameter pytree
(as numpy arrays, dense or hybrid family) into the port's parameter tree,
and :func:`opt_state_from_reference` the reference's AdamW state into the
port's, so that both trainers can start from one state.

Nothing here imports the reference: the object's class name picks the
target and its attributes (plain values and numpy arrays) fill it.  So a
test builds each input once in the reference and converts it, and the two
packages see the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.coding import CodingCandidate
from .core.order_stats import Empirical, Exponential, ShiftedExponential
from .core.planner import ClusterSpec, Objective
from .core.policies import Assignment, PolicyCandidate, ShedPolicy, SloClass
from .core.replication import ReplicationPlan
from .core.simulator import FaultEvent
from .core.tuner import TunerConfig
from .device import resolve_device

__all__ = ["from_reference", "empirical_from_fields", "params_from_reference",
           "opt_state_from_reference"]


def empirical_from_fields(atoms, weights=None) -> Empirical:
    """An ``Empirical`` holding exactly these (already sorted, already
    normalized) atoms and weights — no re-sort and no re-normalization, so
    the cumulative weights match the reference's bit for bit."""
    atoms = tuple(float(a) for a in np.asarray(atoms, dtype=float).ravel())
    if weights is not None:
        weights = tuple(float(w) for w in np.asarray(weights, dtype=float).ravel())
        if len(weights) != len(atoms):
            raise ValueError("weights must match atoms")
    if any(b < a for a, b in zip(atoms, atoms[1:])):
        raise ValueError("atoms must be sorted ascending")
    obj = object.__new__(Empirical)
    object.__setattr__(obj, "atoms", atoms)
    object.__setattr__(obj, "weights", weights)
    return obj


def _fields(obj, names):
    return {n: from_reference(getattr(obj, n)) for n in names}


_SIMPLE = {
    "Exponential": (Exponential, ("mu",)),
    "ShiftedExponential": (ShiftedExponential, ("delta", "mu")),
    "PolicyCandidate": (PolicyCandidate, ("kind", "quantile", "hedge_fraction")),
    "CodingCandidate": (CodingCandidate,
                        ("scheme", "s", "encode_overhead", "decode_overhead")),
    "SloClass": (SloClass, ("name", "share", "weight", "deadline", "miss_target")),
    "ShedPolicy": (ShedPolicy, ("kind", "cap", "utilization")),
    "ClusterSpec": (ClusterSpec, ("n_workers", "dist", "rates", "feasible_b",
                                  "batch_divisor", "max_batches")),
    "Assignment": (Assignment, ("n_workers", "n_units", "batches",
                                "worker_batch")),
    "ReplicationPlan": (ReplicationPlan, ("n_data", "n_batches")),
    "FaultEvent": (FaultEvent, ("worker", "start_step", "end_step")),
    "TunerConfig": (TunerConfig, ("window_steps", "min_samples",
                                  "improvement_threshold", "cooldown_steps",
                                  "metric", "mode", "heterogeneous",
                                  "sim_trials", "sim_seed",
                                  "replan_time_budget", "miss_rate_target",
                                  "miss_window", "gof_alpha",
                                  "bootstrap_resamples")),
    "Objective": (Objective, ("metric", "improvement_threshold",
                              "cooldown_steps", "arrival_rate", "utilization",
                              "job_load", "speculation_quantiles", "policies",
                              "arrivals", "coding", "slo_classes", "batch_size",
                              "max_waits", "sheds")),
}


def from_reference(obj):
    """The port's twin of a reference object (see the module docstring)."""
    if obj is None or isinstance(obj, (bool, int, float, str, np.number,
                                       frozenset)):
        return obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_reference(x) for x in obj)
    name = type(obj).__name__
    if name == "Empirical":
        return empirical_from_fields(obj.atoms, obj.weights)
    if name in _SIMPLE:
        cls, names = _SIMPLE[name]
        return cls(**_fields(obj, names))
    raise TypeError(f"no port twin for {name}")


def _tensor(leaf, device) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype.  ``bfloat16`` (numpy's
    ``ml_dtypes`` type, which ``torch.from_numpy`` refuses) goes through
    float32; bf16 -> f32 -> bf16 is exact."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _layer(sub, idx, dev):
    """Entry ``idx`` (a tuple of leading indices) of every stacked leaf."""
    if isinstance(sub, dict):
        return {k: _layer(v, idx, dev) for k, v in sub.items()}
    return _tensor(np.asarray(sub)[idx], dev)


def _check_stack(sub, lead: tuple, what: str) -> None:
    if isinstance(sub, dict):
        for v in sub.values():
            _check_stack(v, lead, what)
        return
    shape = np.asarray(sub).shape
    if tuple(shape[: len(lead)]) != lead:
        raise ValueError(f"{what} leaf {shape} lacks the leading axes {lead}")


def params_from_reference(cfg, tree, device=None):
    """The port's parameters from the reference's LM parameter pytree.

    ``tree`` is ``repro.models.lm.init_params(key, cfg)`` with its leaves
    as numpy arrays (``jax.tree.map(np.asarray, params)``).  Stacked leaves
    become lists, one dict per layer: the dense family's ``"blocks"``
    (leading axis L) go to ``blocks[i]``; the hybrid family's
    ``"mamba_segments"`` (leading axes n_seg, seg) to
    ``mamba_segments[i][j]`` and ``"mamba_trailing"`` (leading axis
    trailing) to ``mamba_trailing[j]``; its ``"shared_attn"`` is one
    unstacked block.  Dense and hybrid families only.  ``device=None``
    means CUDA.
    """
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    dev = resolve_device(device)
    out = {"embed": _tree(tree["embed"], dev)}
    if cfg.family == "dense":
        _check_stack(tree["blocks"], (cfg.n_layers,), "blocks")
        out["blocks"] = [_layer(tree["blocks"], (i,), dev)
                         for i in range(cfg.n_layers)]
    else:
        k = cfg.hybrid.attn_every
        n_seg, trailing = cfg.n_layers // k, cfg.n_layers % k
        segs = tree["mamba_segments"]
        _check_stack(segs, (n_seg, k), "mamba_segments")
        out["mamba_segments"] = [[_layer(segs, (i, j), dev) for j in range(k)]
                                 for i in range(n_seg)]
        out["shared_attn"] = _tree(tree["shared_attn"], dev)
        if trailing:
            _check_stack(tree["mamba_trailing"], (trailing,), "mamba_trailing")
            out["mamba_trailing"] = [
                _layer(tree["mamba_trailing"], (j,), dev)
                for j in range(trailing)]
    out["final_norm"] = _tree(tree["final_norm"], dev)
    return out


def opt_state_from_reference(cfg, state, device=None):
    """The port's AdamW state from the reference's
    (``repro.optim.init`` / ``update``'s ``{"step", "m", "v", "master"}``,
    leaves as numpy arrays): ``step`` becomes an int32 0-dim tensor, and
    ``m``, ``v`` and ``master`` (the parameters' structure, blocks stacked
    on a layer axis) go through :func:`params_from_reference`, float32
    kept.  ``device=None`` means CUDA."""
    dev = resolve_device(device)
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=dev)}
    for name in ("m", "v", "master"):
        if name in state:
            out[name] = params_from_reference(cfg, state[name], dev)
    return out
