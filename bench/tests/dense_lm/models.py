"""A second family for the test that adds a cell from files alone: a dense
decoder-only LM's model FLOPs, kernel calls and cache sample.  The test
copies it to ``models/dense_lm.py``."""

from __future__ import annotations

import yardstick as Y


def _layer_params(c: dict) -> int:
    d, hd = c["hidden_size"], c["hidden_size"] // c["num_attention_heads"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    return 2 * d * q + 2 * d * kv + 3 * d * c["intermediate_size"]


def _pairs(c: dict, rows: int, seq: int) -> float:
    return (4.0 * rows * c["hidden_size"] * Y.visible_pairs(seq, seq, True)
            * c["num_hidden_layers"])


def train_step_flops(c: dict, rows: int, seq: int) -> float:
    per_token = (_layer_params(c) * c["num_hidden_layers"]
                 + c["hidden_size"] * c["vocab_size"])
    return 6.0 * per_token * rows * seq + 3.0 * _pairs(c, rows, seq)


def prefill_flops(c: dict, rows: int, seq: int) -> float:
    return (2.0 * _layer_params(c) * c["num_hidden_layers"] * rows * seq
            + 2.0 * c["hidden_size"] * c["vocab_size"] * rows
            + _pairs(c, rows, seq))


def kernel_calls(c: dict, rows: int, seq: int, grad: bool,
                 count: int = 1) -> dict:
    return {"flash_attention": [{
        "b": rows, "sq": seq, "skv": seq, "h": c["num_attention_heads"],
        "kv": c["num_key_value_heads"],
        "d": c["hidden_size"] // c["num_attention_heads"], "causal": True,
        "count": c["num_hidden_layers"] * count, "grad": grad}]}


def cache_sample(state: dict, positions) -> dict:
    return {k: state[k][:, :, positions] for k in ("k", "v")}
