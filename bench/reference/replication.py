"""Plain reference of steps of the replication trainer: the paper's
completion rule, the aggregation over the distinct batches, and AdamW,
in float32, over any model given as a loss function of named weights.

It imports nothing of the program.  It is given the weights (and, from a
later step on, AdamW's moments) it starts from, the token rows of each
step, the workers' service times and the number of batches B each step
was split into, and works out the rest again: which batches a step
covers, their mean gradient, the clipped AdamW update with its
learning-rate schedule and bias correction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def worker_batches(n_workers: int, n_batches: int) -> list[int]:
    """Replica-major placement: worker j serves batch j % B."""
    return [j % n_batches for j in range(n_workers)]


def covered_batches(times: np.ndarray, n_batches: int) -> list[int]:
    """Batches with at least one worker that answered (a finite time): the
    completion rule takes each batch's fastest replica, so every such
    batch contributes one gradient."""
    wb = worker_batches(len(times), n_batches)
    return sorted({wb[w] for w in range(len(times)) if np.isfinite(times[w])})


def warmup_cosine(step: int, peak: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    """Linear warm-up from 0, then a cosine decay to final_frac * peak."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (final_frac + (1 - final_frac) * 0.5
                   * (1 + math.cos(math.pi * t)))


def train_steps(loss_fn, weights: dict, batches_of_step, times_of_step,
                batches_at, steps, opt: dict, schedule: dict, moments=None,
                on_first_grad=None):
    """Runs the steps ``steps`` (their indices, in order) from ``weights``
    (float32 tensors, updated in place).  ``batches_of_step(i, b, B)``
    gives (tokens, labels) of batch b; ``times_of_step(i)`` the workers'
    times; ``batches_at(i)`` the B of step i; ``moments`` AdamW's (m, v)
    by leaf before the first step (float32, updated in place; zeros, as
    at step 0, where None); ``on_first_grad`` is called with the first
    step's clipped gradient by leaf.  Returns (losses, the norm of the
    first step's clipped gradient by leaf); the weights after the steps
    are in ``weights``."""
    names = list(weights)
    for w in weights.values():
        w.requires_grad_(True)
    if moments is None:
        moments = ({n: torch.zeros_like(weights[n]) for n in names},
                   {n: torch.zeros_like(weights[n]) for n in names})
    m, v = moments
    b1, b2 = opt["b1"], opt["b2"]
    losses, first_grad = [], None
    for j, i in enumerate(steps):
        n_batches = batches_at(i)
        covered = covered_batches(times_of_step(i), n_batches)
        for w in weights.values():
            w.grad = None
        step_losses = []
        for b in covered:
            tokens, labels = batches_of_step(i, b, n_batches)
            lb = loss_fn(weights, tokens, labels)
            lb.backward()
            step_losses.append(float(lb.detach()))
        losses.append(sum(step_losses) / len(step_losses))
        with torch.no_grad():
            grads = {n: weights[n].grad.div_(len(covered)) for n in names}
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = min(opt["grad_clip"] / max(float(gnorm), 1e-12), 1.0)
            lr = warmup_cosine(i, schedule["lr"], schedule["warmup"],
                               schedule["total_steps"])
            t = i + 1
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for n in names:
                g = grads[n] * scale
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                weights[n].sub_(lr * (u + opt["weight_decay"] * weights[n]))
            if j == 0:
                clipped = {n: grads[n] * scale for n in names}
                first_grad = {n: float(torch.linalg.vector_norm(g))
                              for n, g in clipped.items()}
                if on_first_grad is not None:
                    on_first_grad(clipped)
                del clipped
            del grads
    for w in weights.values():
        w.requires_grad_(False)
        w.grad = None
    return losses, first_grad


__all__ = ["worker_batches", "covered_batches", "warmup_cosine",
           "train_steps"]
