"""The yardstick's part of a decoder-only mixture-of-experts LM: its model
FLOPs from the configuration's own widths (published key names), the
hand-written kernels a step launches and at which shapes, and where the
program's prefill cache holds what the check compares.

A configuration names its family (``"family": "moe_lm"``); the harness
finds this file and ``reference/moe_lm.py`` by that name, so a new family
is a new pair of files and no edit of a mode.
"""

from __future__ import annotations

import yardstick as Y


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def applied_params(c: dict) -> dict:
    """Parameters a token is multiplied by in one decoder layer, and in the
    output head.  Norms and the embedding lookup are not counted."""
    d, hd = c["hidden_size"], head_dim(c)
    q = c["num_attention_heads"] * hd
    kv = c["num_key_value_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    router = d * c["num_experts"]
    experts = c["num_experts_per_tok"] * 3 * d * c["intermediate_size"]
    return {"layer": attn + router + experts, "head": d * c["vocab_size"]}


def attention_pair_flops(c: dict, rows: int, seq: int) -> float:
    """Forward FLOPs of the score and value products of every attention
    layer over ``rows`` causal sequences of ``seq``: 2 products x 2 FLOPs
    a visible (query, key) pair, head and head-dim element."""
    per_layer = (4.0 * rows * c["num_attention_heads"] * head_dim(c)
                 * Y.visible_pairs(seq, seq, True))
    return per_layer * c["num_hidden_layers"]


def train_step_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` x ``seq`` tokens:
    6 x applied parameters x tokens, plus 3 x the forward attention
    products (forward and the two products of the backward)."""
    ap = applied_params(c)
    per_token = ap["layer"] * c["num_hidden_layers"] + ap["head"]
    return (6.0 * per_token * rows * seq
            + 3.0 * attention_pair_flops(c, rows, seq))


def prefill_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``rows`` prompts of ``seq``: 2 x the
    layers' applied parameters x tokens, the output head at the last
    position of each prompt only, plus the forward attention products."""
    ap = applied_params(c)
    return (2.0 * ap["layer"] * c["num_hidden_layers"] * rows * seq
            + 2.0 * ap["head"] * rows
            + attention_pair_flops(c, rows, seq))


def kernel_calls(c: dict, rows: int, seq: int, grad: bool,
                 count: int = 1) -> dict:
    """The hand-written kernels that ``count`` forward passes (and, with
    ``grad``, their backwards) over ``rows`` x ``seq`` tokens launch: one
    causal flash attention a layer."""
    return {"flash_attention": [{
        "b": rows, "sq": seq, "skv": seq, "h": c["num_attention_heads"],
        "kv": c["num_key_value_heads"], "d": head_dim(c), "causal": True,
        "count": c["num_hidden_layers"] * count, "grad": grad}]}


def cache_sample(state: dict, positions) -> dict:
    """What the program's prefill wrote into its decode state, at
    ``positions``: every layer's K and V, (layers, rows, positions, KV
    heads, head_dim) each."""
    return {k: state[k][:, :, positions] for k in ("k", "v")}
