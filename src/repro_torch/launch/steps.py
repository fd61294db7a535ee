"""Step-function factories of the port, as ``repro.launch.steps``.

``make_train_step`` builds the full training step: value and grad of the
(micro-batched) loss, float32 gradient accumulation, AdamW.  The
reference's ``policy`` and ``mesh`` (pod sharding) drop out: the port's
step runs on the device of its parameters, and ``num_microbatches`` (the
reference's ``policy.num_microbatches``) is an argument.
``make_prefill_step`` and ``make_decode_step`` wrap the serving path's
``prefill`` and ``decode_step``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..models import decode_step, prefill, train_loss
from ..optim import AdamWConfig
from ..optim import update as adamw_update
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["value_and_grad", "make_train_step", "make_prefill_step",
           "make_decode_step"]


def value_and_grad(cfg: ArchConfig, params, batch):
    """((loss, metrics), grads) of :func:`train_loss` at ``params``: one
    backward pass; ``grads`` has the parameters' structure and dtypes.
    ``params`` is left as it is (the gradient is taken through detached
    views of its leaves)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = train_loss(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read gets a zero gradient, as under JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(
    cfg: ArchConfig,
    adamw: AdamWConfig = AdamWConfig(),
    num_microbatches: int = 1,
) -> Callable:
    """``train_step(params, opt_state, batch, lr) -> (params, opt_state,
    metrics)``.  With ``num_microbatches`` n > 1 the batch's rows are split
    into n consecutive blocks, and the float32 gradient is the sum of each
    block's gradient divided by n, accumulated in order."""
    n_micro = num_microbatches

    def train_step(params, opt_state, batch, lr):
        if n_micro == 1:
            (loss, metrics), grads = value_and_grad(cfg, params, batch)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            def split(x):
                b = x.shape[0]
                return x.reshape(n_micro, b // n_micro, *x.shape[1:])

            micro = {k: split(torch.as_tensor(v)) for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses, metricses = [], []
            for i in range(n_micro):
                (l, met), g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in micro.items()})
                acc = tree_map(
                    lambda a, gg: a + gg.to(torch.float32) / n_micro, acc, g)
                losses.append(l)
                metricses.append(met)
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        new_params, new_opt, om = adamw_update(
            grads, opt_state, params, lr, adamw
        )
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss_total"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig,
                      max_len: Optional[int] = None) -> Callable:
    """``prefill_step(params, batch) -> (last logits, decode state)``, the
    cache sized ``max_len`` (default: the prompt's length)."""

    def prefill_step(params, batch):
        seq = batch["tokens"].shape[1]
        return prefill(cfg, params, batch, max_len=max_len or seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``step(params, state, token, cache_len) -> (logits, state)``."""

    def step(params, state, token, cache_len):
        return decode_step(cfg, params, state, token, cache_len)

    return step
