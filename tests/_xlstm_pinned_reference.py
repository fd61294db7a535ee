"""The reference's reduced xlstm run on XLA's SSE4.2 code, in a process of
its own: ``python tests/_xlstm_pinned_reference.py IN.npz OUT.npz``.

``IN`` holds ``n_layers``, the prompt ``tokens`` (B, S) and the greedy
``steps`` (STEPS, B, 1) that ``tests/test_torch_xlstm.py`` fed both
packages; ``OUT`` gets every state key after the last decode step.  The
caller runs this with ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``: XLA's CPU
code for ``tanh``, ``exp``, ``rsqrt`` and the logistic functions differs
with the host's vector ISA (on AVX2 hosts it uses FMAs), and those last
bits carry through the sLSTM recurrence into the trailing blocks' state.
Pinned to one ISA, the reference gives the same state on every x86 host.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), "src")]

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import Shard, decode_step, init_params, prefill  # noqa: E402
from test_torch_xlstm import ARCH, MAX_LEN, _seeded_scales  # noqa: E402


def main(src, dst):
    inp = np.load(src)
    toks, steps = inp["tokens"], inp["steps"]
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              n_layers=int(inp["n_layers"]))
    params = jax.tree.map(jnp.asarray, _seeded_scales(
        init_params(jax.random.PRNGKey(0), cfg)))
    shard = Shard.local()
    _, state = prefill(cfg, shard, params,
                       {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    step = jax.jit(lambda p, s, t, c: decode_step(cfg, shard, p, s, t, c))
    for i, tok in enumerate(steps):
        _, state = step(params, state, jnp.asarray(tok, jnp.int32),
                        jnp.int32(toks.shape[1] + i))
    np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in state.items()})


if __name__ == "__main__":
    main(*sys.argv[1:3])
