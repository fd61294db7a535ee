"""Meta-device stand-ins and placements for every step argument.

The counterpart of ``repro.launch.specs``: where the reference gives
``jax.ShapeDtypeStruct`` trees and ``PartitionSpec`` trees for a jitted
step, the port gives trees of meta tensors (shape and dtype, nothing
allocated) and placement trees (``models.param_specs``' tuples).  The
dtypes are the port's own: integer batch entries ``long``, float ones
float32, as ``launch.train.Trainer`` hands them to ``train_loss``.
"""

from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig, ShapeCell, ShardingPolicy
from ..data.pipeline import make_batch_shapes

__all__ = ["input_specs", "params_shapes"]

META = torch.device("meta")


@functools.lru_cache(maxsize=16)
def params_shapes(cfg: ArchConfig):
    """The parameter tree on the meta device (no allocation), built once a
    config: the tree is shared, so callers do not modify it."""
    from ..models.lm import _build

    cfg.validate()
    return _build(None, cfg, META)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, cell: ShapeCell, policy: ShardingPolicy,
                mesh_shape):
    """Returns (args, placements) for the step function of this cell:

    train:   (params, opt_state, batch, lr)
    prefill: (params, batch)
    decode:  (params, state, token, cache_len)

    ``args`` are meta tensors; ``placements`` the matching tuples.
    """
    from ..models.lm import decode_state_shapes, decode_state_specs
    from ..models.lm import param_specs as model_param_specs
    from ..optim import AdamWConfig
    from ..optim import init as opt_init
    from ..optim import state_specs as opt_state_specs

    dp_total = 1
    for a in policy.dp_axes:
        dp_total *= mesh_shape[a]

    shapes = make_batch_shapes(cfg, cell)
    gb = next(iter(shapes.values()))[0]
    batch_lead = policy.dp_axes if (gb % dp_total == 0
                                    and gb >= dp_total) else None
    batch = {name: _meta(shape, torch.long if name in (
        "tokens", "labels", "token") else torch.float32)
        for name, shape in shapes.items()}
    batch_ps = {name: (batch_lead,) + (None,) * (len(shape) - 1)
                for name, shape in shapes.items()}

    pshapes = params_shapes(cfg)
    pspecs = model_param_specs(cfg, policy)

    if cell.kind == "train":
        ocfg = AdamWConfig()
        oshapes = opt_init(pshapes, ocfg)
        ospecs = opt_state_specs(pspecs, ocfg)
        return ((pshapes, oshapes, batch, _meta((), torch.float32)),
                (pspecs, ospecs, batch_ps, ()))
    if cell.kind == "prefill":
        return (pshapes, batch), (pspecs, batch_ps)
    if cell.kind == "decode":
        state = {k: _meta(shape, dt) for k, (shape, dt) in
                 decode_state_shapes(cfg, gb, cell.seq_len).items()}
        state_ps = decode_state_specs(cfg, policy,
                                      batch_shardable=batch_lead is not None)
        return ((pshapes, state, _meta((gb, 1), torch.long),
                 _meta((), torch.int32)),
                (pspecs, state_ps, (batch_lead, None), ()))
    raise ValueError(cell.kind)
