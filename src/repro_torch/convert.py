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
(as numpy arrays, any family) into the port's parameter tree,
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
from .models import lm

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


def _stack(tree, name, lead, dev):
    """The stacked subtree ``tree[name]`` as nested lists of per-block
    dicts, one level a leading axis in ``lead``."""
    sub = tree[name]
    _check_stack(sub, lead, name)

    def nest(prefix):
        if len(prefix) == len(lead):
            return _layer(sub, prefix, dev)
        return [nest(prefix + (i,)) for i in range(lead[len(prefix)])]
    return nest(())


def params_from_reference(cfg, tree, device=None):
    """The port's parameters from the reference's LM parameter pytree.

    ``tree`` is ``repro.models.lm.init_params(key, cfg)`` with its leaves
    as numpy arrays (``jax.tree.map(np.asarray, params)``).  Stacked leaves
    become lists, one dict per block, a list level per leading axis: the
    dense, vlm and moe families' ``"blocks"`` (leading axis L, or L - 1
    beside moe's unstacked ``"dense_block"``); the hybrid family's
    ``"mamba_segments"`` (n_seg, seg) and ``"mamba_trailing"`` (trailing),
    its ``"shared_attn"`` one unstacked block; xLSTM's
    ``"mlstm_segments"`` (n_seg, m_per), ``"slstm_blocks"`` (n_seg) and
    ``"mlstm_trailing"`` (trailing); whisper's ``"enc_blocks"`` and
    ``"dec_blocks"`` (L each).  Unstacked entries (vlm's ``"projector"``,
    whisper's ``"frontend"``, ``"enc_norm"``, ``"dec_norm"``) carry over
    as they are.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        k = cfg.hybrid.attn_every
        n_seg, trailing = cfg.n_layers // k, cfg.n_layers % k
        stacks = {"mamba_segments": (n_seg, k), "mamba_trailing": (trailing,)}
    elif cfg.family == "ssm":
        n_seg, m_per, trailing = lm._xlstm_layout(cfg)
        stacks = {"mlstm_segments": (n_seg, m_per), "slstm_blocks": (n_seg,),
                  "mlstm_trailing": (trailing,)}
    elif cfg.family == "audio":
        stacks = {"enc_blocks": (cfg.n_layers,),
                  "dec_blocks": (cfg.n_layers,)}
    elif cfg.family == "moe":
        dense = 1 if cfg.moe.first_layer_dense else 0
        stacks = {"blocks": (cfg.n_layers - dense,)}
    elif cfg.family in ("dense", "vlm"):
        stacks = {"blocks": (cfg.n_layers,)}
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    # the port's own top-level order (init_params's, on the meta device)
    names = list(lm._build(None, cfg, torch.device("meta")))
    if sorted(names) != sorted(tree):
        raise ValueError(f"{cfg.name}: the tree has {sorted(tree)}, the port "
                         f"builds {sorted(names)}")
    out = {}
    for name in names:
        if name in stacks:
            out[name] = _stack(tree, name, stacks[name], dev)
        elif isinstance(tree[name], dict):
            out[name] = _tree(tree[name], dev)
        else:
            out[name] = _tensor(tree[name], dev)
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
