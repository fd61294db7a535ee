"""AdamW with float32 master weights, on trees of tensors.

Functional API (no optimizer classes), as ``repro.optim.adamw``:

    state = init(params, cfg)
    new_params, new_state, metrics = update(grads, state, params, lr, cfg)
    params, state, metrics = update_(grads, state, params, lr, cfg)

``params`` is the port's parameter tree (nested dicts and lists of
tensors); the state is ``{"step": int32 0-dim, "m", "v", "master"}`` with
``m``, ``v`` and ``master`` float32 trees of the parameters' structure.
Gradients arrive in float32 (cast by the train step).  :func:`state_specs`
is the state's placement tree on a production mesh: ``m``, ``v`` and
``master`` take the parameters' placements (``models.param_specs``),
``step`` is whole, as the reference's ``state_specs``.

The arithmetic is the reference's, in float32: the bias corrections are
``1 - b ** step`` with the power taken in float32 (a Python ``b ** step``
would be float64 and round differently), and the clip scale, the moments
and the update follow the reference's expression order.  ``update`` runs
them leaf by leaf, so besides the old and new state it holds one leaf's
temporaries at a time, not a float32 tree of each (the scaled gradient,
the moments' terms).  ``update_`` writes the new moments, master weights
and parameters into the given state's and parameters' tensors and returns
those trees: a step then holds one state (14 bytes a parameter), not two
(28).  ``update`` is ``update_`` on copies, so the two give the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init", "update", "update_", "state_specs",
           "global_norm", "sqrt_"]

F32 = torch.float32
# elements of a leaf that :func:`sqrt_` widens to float64 at a time (32 MB)
_SQRT_CHUNK = 1 << 22


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


def state_specs(param_specs, cfg: AdamWConfig = AdamWConfig()):
    """The placement tree of :func:`init`'s state, from the parameters'."""
    specs = {"step": (), "m": param_specs, "v": param_specs}
    if cfg.master_fp32:
        specs["master"] = param_specs
    return specs


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.to(F32))) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def sqrt_(x: torch.Tensor) -> torch.Tensor:
    """``x`` <- its square root, correctly rounded in float32 as ``np.sqrt``
    and ``jnp.sqrt`` are.  On the CPU, float32 ``torch.sqrt`` is not
    correctly rounded on some hosts (its vectorised path may be one
    spacing off), so the root is taken in float64 and rounded back, which
    is correctly rounded (53 >= 2 * 24 + 2 bits), a chunk of the leaf at a
    time so that no float64 copy of a whole embedding is held.  On the
    card ``torch.sqrt`` is CUDA's IEEE ``sqrtf``, correctly rounded
    (``chip_smoke.py`` holds it bit-equal to the float64 route), and the
    roofline's meta-device walk counts that op.  ``x`` is float32 and
    contiguous."""
    if x.device.type != "cpu":
        return x.sqrt_()
    flat = x.view(-1)
    for i in range(0, flat.numel(), _SQRT_CHUNK):
        c = flat[i:i + _SQRT_CHUNK]
        c.copy_(c.double().sqrt_())
    return x


def update(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_state, metrics), leaving ``state`` and
    ``params`` as they were: :func:`update_` on copies of them."""
    copy = lambda t: t.detach().clone()  # noqa: E731
    return update_(grads, tree_map(copy, state), tree_map(copy, params), lr,
                   cfg)


def update_(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig()):
    """Updates the state's moments and master weights and the parameters in
    their own tensors; returns (params, new_state, metrics), the new state
    holding those tensors and the next step."""
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
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * g * g)
        # each temporary is freed once used: an embedding leaf can hold 1 G
        # elements, 4 GB a float32 temporary
        u = (m_ / bc1) / sqrt_(v_ / bc2).add_(cfg.eps)
        del g
        step_ = lr * (u + cfg.weight_decay * p32.to(F32))
        del u
        if p32.dtype == F32:
            p32.sub_(step_)
        else:  # bf16 parameters without a master: the step in float32
            p32 = p32.to(F32) - step_
        p.copy_(p32)

    for args in zip(tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), tree_leaves(ref),
                    tree_leaves(params)):
        leaf(*args)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if cfg.master_fp32:
        new_state["master"] = state["master"]
    return params, new_state, {"grad_norm": gnorm, "clip_scale": scale}
