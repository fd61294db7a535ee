"""The port's dense LM against the reference's, on the CPU.

``reduced_config(qwen2-0.5b)`` (4 layers, d_model 128, 2 heads of 64, GQA
kept) in both packages.  The reference's parameters are initialised from
its JAX key, the QKV biases and norm scales are then set to seeded
non-trivial values (the reference initialises them to 0 and 1, which
would leave those paths untested), and the same numpy tree goes into the
reference and, through ``params_from_reference``, into the port.

The port's ``prefill`` and four ``decode_step``s must give the
reference's logits within 4e-2 absolute (the logits lie within +-1 here,
so that is about ten bfloat16 ulps): both run in bfloat16, but round at
different points (XLA fuses the float32 norm, RoPE and softmax chains and
the matmuls accumulate in different orders), and the differences grow
through the residual stream.  Measured: at most 1.6e-2 on logits up to
0.89.  The decode-against-prefill check uses the same bound; on the CPU
the two paths agree bit for bit.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import Shard
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import count_params, decode_step, init_params, prefill
from repro_torch.models import lm

ATOL = 4e-2
B, S, MAX_LEN, STEPS = 2, 24, 48, 4


def _with_bias(tree, seed=0):
    """The tree as numpy, with every bias and norm scale of the blocks set
    to seeded values."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for group in out["blocks"].values():
        for name, a in group.items():
            if name.startswith("b"):
                group[name] = (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
            elif name == "scale":
                group[name] = (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return out


@pytest.fixture(scope="module")
def models():
    rcfg = ref_reduced_config(ref_get_config("qwen2-0.5b"))
    cfg = reduced_config(get_config("qwen2-0.5b"))
    tree = _with_bias(ref_init_params(jax.random.PRNGKey(0), rcfg))
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_reference(cfg, tree, device="cpu")
    return rcfg, cfg, rparams, tparams, tree


@pytest.fixture(scope="module")
def runs(models):
    """Prefill + STEPS greedy decode steps in both packages, each fed the
    reference's greedy tokens."""
    rcfg, cfg, rparams, tparams, _ = models
    shard = Shard.local()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, MAX_LEN)
    ref_logits, port_logits, fed = [rl], [tl], []
    step = jax.jit(lambda p, s, t, c: ref_decode_step(rcfg, shard, p, s, t, c))
    for i in range(STEPS):
        tok = np.array(jnp.argmax(ref_logits[-1][:, -1], axis=-1))[:, None]
        fed.append(tok)
        rl, rs = step(rparams, rs, jnp.asarray(tok, jnp.int32), jnp.int32(S + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), S + i)
        ref_logits.append(rl)
        port_logits.append(tl)
    return toks, fed, ref_logits, port_logits, rs, ts


def test_config_matches_reference():
    for arch in ("qwen2-0.5b",):
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                     "vocab_size", "qkv_bias", "norm", "activation",
                     "rope_theta", "tie_embeddings", "head_dim"):
            assert getattr(cfg, name) == getattr(rcfg, name), name
            assert (getattr(reduced_config(cfg), name)
                    == getattr(ref_reduced_config(rcfg), name)), name
    assert get_config("xlstm-350m").family == "ssm"  # every arch is ported
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_conversion_maps_every_layer(models):
    _, cfg, _, tparams, tree = models
    assert len(tparams["blocks"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        for path in (("attn", "wq"), ("attn", "bk"), ("mlp", "wo"),
                     ("ln2", "scale")):
            got = tparams["blocks"][i][path[0]][path[1]]
            want = tree["blocks"][path[0]][path[1]][i]
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    assert torch.equal(tparams["embed"]["tokens"].float(),
                       torch.from_numpy(tree["embed"]["tokens"].astype(np.float32)))


def test_init_params_shapes_and_scales():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    rcfg = ref_reduced_config(ref_get_config("qwen2-0.5b"))
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref_shapes = jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0), rcfg))
    assert tuple(p["embed"]["tokens"].shape) == ref_shapes["embed"]["tokens"].shape
    for name, leaf in ref_shapes["blocks"]["attn"].items():
        assert tuple(p["blocks"][0]["attn"][name].shape) == leaf.shape[1:], name
    for name, leaf in ref_shapes["blocks"]["mlp"].items():
        assert tuple(p["blocks"][0]["mlp"][name].shape) == leaf.shape[1:], name
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref_shapes))
    assert count_params(p) == n_ref
    wq = p["blocks"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    emb = p["embed"]["tokens"].float()
    assert abs(emb.std().item() - 0.02) < 0.002
    again = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["blocks"][3]["mlp"]["wo"], p["blocks"][3]["mlp"]["wo"])


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_logits_match_reference(runs, step):
    _, _, ref_logits, port_logits, _, _ = runs
    ref = np.asarray(ref_logits[step], np.float32)
    port = port_logits[step]
    assert port.shape == ref.shape and port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL, rtol=0)


def test_kv_cache_matches_reference(runs):
    _, _, _, _, rs, ts = runs
    for name in ("k", "v"):
        ref = np.asarray(rs[name], np.float32)
        port = ts[name].float().numpy()
        assert port.shape == ref.shape
        np.testing.assert_allclose(port[:, :, : S + STEPS], ref[:, :, : S + STEPS],
                                   atol=0.1, rtol=5e-2)
        assert not port[:, :, S + STEPS:].any() and not ref[:, :, S + STEPS:].any()


def test_decode_matches_teacher_forced_prefill(models, runs):
    """Step i's logits equal the last-position logits of a prefill over the
    prompt and the tokens fed so far (same package, so only the attention
    path differs: the decode kernel against the prefill kernel)."""
    _, cfg, _, tparams, _ = models
    toks, fed, _, port_logits, _, _ = runs
    for i in range(STEPS):
        seq = np.concatenate([toks] + fed[: i + 1], axis=1)
        tl, _ = prefill(cfg, tparams, {"tokens": torch.as_tensor(seq)}, MAX_LEN)
        np.testing.assert_allclose(port_logits[i + 1].float().numpy(),
                                   tl.float().numpy(), atol=ATOL, rtol=0)


VARIANTS = {
    # command-r style: parallel attention + FFN, LayerNorm, output bias,
    # untied unembedding
    "parallel_layernorm": dict(parallel_block=True, norm="layernorm",
                               attn_out_bias=True, tie_embeddings=False),
    # GELU FFN with biases, no QKV bias
    "gelu_bias": dict(activation="gelu", mlp_bias=True, qkv_bias=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_variants_match_reference(variant):
    """The dense family's other switches (the paths qwen2 does not take):
    prefill and two decode steps against the reference."""
    import dataclasses

    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config("qwen2-0.5b")),
                               n_layers=2, **VARIANTS[variant])
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")),
                              n_layers=2, **VARIANTS[variant])
    tree = _with_bias(ref_init_params(jax.random.PRNGKey(5), rcfg), seed=5)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_reference(cfg, tree, device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 20))
    shard = Shard.local()
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, 32)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, 32)
    for i in range(3):
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(rl, np.float32),
                                   atol=ATOL, rtol=0)
        tok = np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None]
        rl, rs = ref_decode_step(rcfg, shard, rparams, rs,
                                 jnp.asarray(tok, jnp.int32), jnp.int32(20 + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), 20 + i)


def test_rope_matches_reference():
    from repro.models.layers import apply_rope as ref_apply_rope
    from repro_torch.models.layers import apply_rope

    x = np.random.default_rng(7).standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.arange(100, 109)
    ref = ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_other_families_and_bad_positions_raise(models):
    import dataclasses

    _, cfg, _, tparams, _ = models
    with pytest.raises(NotImplementedError, match="audio"):  # as the reference
        prefill(dataclasses.replace(cfg, family="audio"), tparams,
                {"tokens": torch.zeros((1, 4), dtype=torch.long)}, 8)
    state = lm.init_decode_state(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="cache_len"):
        decode_step(cfg, tparams, state, torch.zeros((1, 1), dtype=torch.long), 8)
    with pytest.raises(ValueError, match="max_len"):
        prefill(cfg, tparams, {"tokens": torch.zeros((1, 9), dtype=torch.long)}, 8)
