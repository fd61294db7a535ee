"""Error-feedback int8 gradient compression, as ``repro.optim.compression``.

Used on the cross-batch reduction path: quantize each gradient leaf to int8
with a per-leaf float32 scale, sum the dequantized leaves across workers,
divide by their count.  The quantization residual is carried in a local
error buffer and added back before the next step's quantization (error
feedback, Seide et al. / Karimireddy et al.).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the same float32 trees give the
reference's bits.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "init_error_state",
    "compress",
    "decompress",
    "compressed_reduce_host",
]


def init_error_state(params):
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compress(grad, error):
    """grad, error: float32 leaf.  Returns (q int8, scale f32, new_error)."""
    g = grad + error
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_error = g - q.to(torch.float32) * scale
    return q, scale, new_error


def decompress(q, scale):
    return q.to(torch.float32) * scale


def compressed_reduce_host(grad_trees, error_trees):
    """Host-side reference reduction with error feedback.

    grad_trees: list of float32 trees (one per contributing worker/batch);
    error_trees: matching list of error buffers.  Returns (mean_tree,
    new_error_trees), summed in the reference's order (the first worker's
    dequantized leaf, then each next one added).
    """
    n = len(grad_trees)
    qs, scales, new_errors = [], [], []
    for g, e in zip(grad_trees, error_trees):
        out = [compress(gl, el)
               for gl, el in zip(tree_leaves(g), tree_leaves(e))]
        qs.append([o[0] for o in out])
        scales.append([o[1] for o in out])
        new_errors.append(tree_unflatten(g, [o[2] for o in out]))
    acc = [q.to(torch.float32) * s for q, s in zip(qs[0], scales[0])]
    for q, s in zip(qs[1:], scales[1:]):
        acc = [a + qq.to(torch.float32) * ss for a, qq, ss in zip(acc, q, s)]
    mean = tree_unflatten(grad_trees[0], [a / n for a in acc])
    return mean, new_errors
