"""AdamW with float32 master weights, on trees of tensors.

Functional API (no optimizer classes), as ``repro.optim.adamw``:

    state = init(params, cfg)
    new_params, new_state, metrics = update(grads, state, params, lr, cfg)

``params`` is the port's parameter tree (nested dicts and lists of
tensors); the state is ``{"step": int32 0-dim, "m", "v", "master"}`` with
``m``, ``v`` and ``master`` float32 trees of the parameters' structure.
Gradients arrive in float32 (cast by the train step).  The reference's
``state_specs`` (a ``PartitionSpec`` tree for pod sharding) waits with the
port's sharding.

The arithmetic is the reference's, in float32: the bias corrections are
``1 - b ** step`` with the power taken in float32 (a Python ``b ** step``
would be float64 and round differently), and the clip scale, the moments
and the update follow the reference's expression order.  ``update`` runs
them leaf by leaf, so besides the old and new state it holds one leaf's
temporaries at a time, not a float32 tree of each (the scaled gradient,
the moments' terms).
"""

from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "init", "update", "global_norm"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True


def init(params, cfg: AdamWConfig = AdamWConfig()):
    leaf = tree_leaves(params)[0]
    zeros32 = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(lambda p: p.detach().to(F32, copy=True),
                                   params)
    return state


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.to(F32))) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def update(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=stepf.device), stepf)

    ref = state["master"] if cfg.master_fp32 else params

    def leaf(g, m_, v_, p32, p):
        g = g.to(F32) * scale
        m_ = b1 * m_ + (1 - b1) * g
        v_ = b2 * v_ + (1 - b2) * g * g
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        p32 = p32.to(F32)
        p32 = p32 - lr * (u + cfg.weight_decay * p32)
        return m_, v_, p32, p32.to(p.dtype)

    outs = [leaf(*args) for args in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(ref), tree_leaves(params))]
    m, v, new_master, new_params = (tree_unflatten(params, list(col))
                                    for col in zip(*outs))
    new_state = {"step": step, "m": m, "v": v}
    if cfg.master_fp32:
        new_state["master"] = new_master
    return new_params, new_state, {"grad_norm": gnorm, "clip_scale": scale}
