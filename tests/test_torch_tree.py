"""The port's trees hold no reference cycles, on the CPU.

A tree of the training path (a gradient tree, the AdamW state) is freed as
soon as its last reference goes, with Python's cyclic garbage collector
off: a cycle would keep every tensor of the tree alive until the collector
ran, and on the card that is gigabytes a step (a full-width model's float32
gradient tree is 4 bytes a parameter).
"""

import gc
import weakref

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import init_params
from repro_torch.optim import init as adamw_init
from repro_torch.optim import update as adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _freed_without_gc(make):
    """Whether every tensor ``make()`` returns (a list of trees) dies with
    its last reference while the cyclic collector is off."""
    gc.collect()
    gc.disable()
    try:
        trees = make()
        refs = [weakref.ref(t) for tree in trees for t in tree_leaves(tree)]
        del trees
        return all(r() is None for r in refs)
    finally:
        gc.enable()


def test_unflatten_keeps_no_reference_to_its_leaves():
    like = {"b": [1, {"c": 2}], "a": (3,)}

    def make():
        return [tree_unflatten(like, [torch.ones(2) for _ in range(3)])]

    assert _freed_without_gc(make)
    out = tree_unflatten(like, [torch.full((1,), float(i)) for i in range(3)])
    assert [float(t) for t in tree_leaves(out)] == [0.0, 1.0, 2.0]
    assert list(out) == ["b", "a"]


def test_a_training_step_leaves_no_tree_in_a_cycle():
    """The gradients of ``value_and_grad`` (dense and hybrid), and the old
    and new AdamW state of an update, die with their references."""
    for arch in ("qwen2-0.5b", "zamba2-7b"):
        cfg = reduced_config(get_config(arch))
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

        def grads():
            return [value_and_grad(cfg, params, batch)[1]]

        assert _freed_without_gc(grads), arch

        def step():
            state = adamw_init(params)
            g = tree_map(lambda p: torch.ones_like(p, dtype=torch.float32),
                         params)
            new_params, new_state, _ = adamw_update(g, state, params, 1e-3)
            return [state, new_state, new_params, g]

        assert _freed_without_gc(step), arch
