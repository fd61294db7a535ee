"""The port's hybrid LM (zamba2) against the reference's, on the CPU.

``reduced_config(zamba2-7b)`` (4 layers, attn_every 2: two segments of two
Mamba-2 blocks and the shared block; d_model 128, SSM heads of P = 32, N =
16, chunk 16) in both packages, and a 5-layer variant with one trailing
Mamba-2 block.  The reference's parameters are initialised from its JAX
key; the norm scales, conv bias, ``a_log``, ``d_skip`` and ``dt_bias`` are
then set to seeded non-trivial values (the reference's 1, 0, 0, 1, 0 would
leave those paths untested, and ``dt_bias`` near -2.5 keeps the decay
mild, so the state carried across chunks matters), and the same numpy
tree goes into the reference and, through ``params_from_reference``, into
the port.

Logits of prefill and of four decode steps must meet the reference's
within 4e-2 absolute, as for the dense family (both run in bfloat16 and
round at different points).  The decode state (SSM states, conv tails, KV
caches) must meet the reference's, and a decode step must equal a
teacher-forced prefill of the same tokens.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as port_serve
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import Shard
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.zamba import zamba_decode_state_shape as ref_zamba_state_shape
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import (count_params, decode_step, init_decode_state,
                                init_params, prefill)
from repro_torch.models import zamba

ATOL = 4e-2
B, STEPS = 2, 4
# (layers, prompt length): two chunks of 16; one ragged chunk of 21
DEPTHS = {4: 32, 5: 21}
# the untied unembedding (d^-0.5) gives logits of unit scale; a final norm
# scale of 1/4 brings them within about +-1, where 4e-2 is about ten
# bfloat16 ulps, as in the dense test (tied embeddings at 0.02)
FINAL_SCALE = 0.25
SSM_TOL = dict(atol=3e-2, rtol=3e-2)
CACHE_TOL = dict(atol=0.1, rtol=5e-2)


def _configs(n_layers):
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config("zamba2-7b")),
                               n_layers=n_layers)
    cfg = dataclasses.replace(reduced_config(get_config("zamba2-7b")),
                              n_layers=n_layers)
    return rcfg, cfg


def _seeded(tree, seed):
    """The tree as numpy, with the Mamba-2 blocks' and the shared block's
    small parameters set to seeded values."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)

    def draw(a, name):
        shape, dt = a.shape, a.dtype
        if name == "dt_bias":
            v = -2.5 + 0.5 * rng.standard_normal(shape)
        elif name == "a_log":
            v = 0.3 * rng.standard_normal(shape)
        elif name in ("d_skip", "scale"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "conv_b":
            v = 0.1 * rng.standard_normal(shape)
        else:
            return a
        return v.astype(dt)

    def walk(node):
        for k, v in node.items():
            node[k] = walk(v) if isinstance(v, dict) else draw(v, k)
        return node

    for key in ("mamba_segments", "mamba_trailing", "shared_attn"):
        if key in out:
            walk(out[key])
    scale = out["final_norm"]["scale"]
    out["final_norm"]["scale"] = (
        FINAL_SCALE * (1.0 + 0.1 * rng.standard_normal(scale.shape))
    ).astype(scale.dtype)
    return out


def _build(n_layers, seed=0):
    rcfg, cfg = _configs(n_layers)
    tree = _seeded(ref_init_params(jax.random.PRNGKey(seed), rcfg), seed)
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module", params=sorted(DEPTHS))
def runs(request):
    """Prefill + STEPS greedy decode steps in both packages, each fed the
    reference's greedy token."""
    n_layers = request.param
    s = DEPTHS[n_layers]
    max_len = s + STEPS + 4
    rcfg, cfg, rparams, tree = _build(n_layers)
    tparams = params_from_reference(cfg, tree, device="cpu")
    shard = Shard.local()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, s))
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, max_len)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, max_len)
    states = [(jax.tree.map(np.asarray, rs),
               {k: v.clone() for k, v in ts.items()})]
    ref_logits, port_logits, fed = [rl], [tl], []
    step = jax.jit(lambda p, st, t, c: ref_decode_step(rcfg, shard, p, st, t, c))
    for i in range(STEPS):
        tok = np.array(jnp.argmax(ref_logits[-1][:, -1], axis=-1))[:, None]
        fed.append(tok)
        rl, rs = step(rparams, rs, jnp.asarray(tok, jnp.int32), jnp.int32(s + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), s + i)
        ref_logits.append(rl)
        port_logits.append(tl)
    states.append((jax.tree.map(np.asarray, rs), ts))
    return dict(n_layers=n_layers, s=s, max_len=max_len, cfg=cfg,
                tparams=tparams, toks=toks, fed=fed, ref_logits=ref_logits,
                port_logits=port_logits, states=states)


def test_config_matches_reference():
    rcfg, cfg = ref_get_config("zamba2-7b"), get_config("zamba2-7b")
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "norm", "activation", "rope_theta",
                 "tie_embeddings", "head_dim", "family"):
        assert getattr(cfg, name) == getattr(rcfg, name), name
        assert (getattr(reduced_config(cfg), name)
                == getattr(ref_reduced_config(rcfg), name)), name
    for sub in ("ssm", "hybrid"):
        for c, r in ((cfg, rcfg), (reduced_config(cfg), ref_reduced_config(rcfg))):
            mine, theirs = getattr(c, sub), getattr(r, sub)
            for f in dataclasses.fields(mine):
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert cfg.head_dim == 112
    assert zamba.segment_layout(cfg) == (13, 6, 3)


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_logits_match_reference(runs, step):
    ref = np.asarray(runs["ref_logits"][step], np.float32)
    port = runs["port_logits"][step]
    assert port.shape == ref.shape and port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL, rtol=0)


def test_matches_the_reference_op_by_op():
    """The 4e-2 above is the reference's XLA fusion, not the port: run op
    by op (``jax.disable_jit``), the reference rounds where the port does,
    and on the 5-layer model prefill and a decode step agree bit for bit
    in the logits, conv tails and KV caches, and the float32 SSM states to
    summation order."""
    rcfg, cfg, rparams, tree = _build(5)
    tparams = params_from_reference(cfg, tree, device="cpu")
    s, max_len = 9, 10
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, s))
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 1))
    shard = Shard.local()
    with jax.disable_jit():
        rl, rs = ref_prefill(rcfg, shard, rparams,
                             {"tokens": jnp.asarray(toks, jnp.int32)}, max_len)
        rl2, rs = ref_decode_step(rcfg, shard, rparams, rs,
                                  jnp.asarray(tok, jnp.int32), jnp.int32(s))
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, max_len)
    tl2, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), s)
    for port, ref in ((tl, rl), (tl2, rl2)):
        np.testing.assert_array_equal(port.float().numpy(),
                                      np.asarray(ref, np.float32))
    for name, t in ts.items():
        want = np.asarray(rs[name], np.float32)
        if name.endswith("_ssm"):
            np.testing.assert_allclose(t.numpy(), want, atol=1e-4, rtol=1e-4)
        else:
            np.testing.assert_array_equal(t.float().numpy(), want)


@pytest.mark.parametrize("when", ["prefill", "decoded"])
def test_decode_state_matches_reference(runs, when):
    ref, port = runs["states"][0 if when == "prefill" else 1]
    assert set(port) == set(ref)
    n_seg, _, trailing = zamba.segment_layout(runs["cfg"])
    assert ("trail_ssm" in port) == (trailing > 0)
    filled = runs["s"] + (0 if when == "prefill" else STEPS)
    for name, t in port.items():
        want = np.asarray(ref[name], np.float32)
        assert tuple(t.shape) == want.shape, name
        assert t.dtype == zamba.STATE_DTYPES[name], name
        got = t.float().numpy()
        if name.startswith("attn_"):
            np.testing.assert_allclose(got[:, :, :filled], want[:, :, :filled],
                                       **CACHE_TOL)
            assert not got[:, :, filled:].any()
        elif name.endswith("_conv"):
            np.testing.assert_allclose(got, want, **CACHE_TOL)
        else:
            assert np.abs(want).max() > 1e-2  # the states carry something
            np.testing.assert_allclose(got, want, **SSM_TOL)


def test_decode_matches_teacher_forced_prefill(runs):
    """Step i's logits equal the last-position logits of a prefill over the
    prompt and the tokens fed so far (same package: the recurrent SSM step
    and the decode attention against the chunked scan and prefill
    attention)."""
    cfg, tparams = runs["cfg"], runs["tparams"]
    for i in range(STEPS):
        seq = np.concatenate([runs["toks"]] + runs["fed"][: i + 1], axis=1)
        tl, _ = prefill(cfg, tparams, {"tokens": torch.as_tensor(seq)},
                        runs["max_len"])
        np.testing.assert_allclose(runs["port_logits"][i + 1].float().numpy(),
                                   tl.float().numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_layers", sorted(DEPTHS))
def test_conversion_maps_every_leaf(n_layers):
    rcfg, cfg, _, tree = _build(n_layers, seed=3)
    tparams = params_from_reference(cfg, tree, device="cpu")
    n_seg, seg, trailing = zamba.segment_layout(cfg)
    assert len(tparams["mamba_segments"]) == n_seg
    assert all(len(s) == seg for s in tparams["mamba_segments"])
    assert len(tparams.get("mamba_trailing", [])) == trailing
    ref_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    n_checked = 0
    for path, want in ref_leaves:
        keys = [p.key for p in path]
        node = tparams[keys[0]]
        if keys[0] == "mamba_segments":
            for idx in np.ndindex(want.shape[:2]):
                leaf = node[idx[0]][idx[1]]
                for k in keys[1:]:
                    leaf = leaf[k]
                np.testing.assert_array_equal(leaf.float().numpy(),
                                              want[idx].astype(np.float32))
                n_checked += 1
            continue
        if keys[0] == "mamba_trailing":
            for j in range(want.shape[0]):
                leaf = node[j]
                for k in keys[1:]:
                    leaf = leaf[k]
                np.testing.assert_array_equal(leaf.float().numpy(),
                                              want[j].astype(np.float32))
                n_checked += 1
            continue
        for k in keys[1:]:
            node = node[k]
        assert str(node.dtype).split(".")[1] == want.dtype.name, keys
        np.testing.assert_array_equal(node.float().numpy(),
                                      want.astype(np.float32))
        n_checked += 1
    per_block = len(jax.tree.leaves(tree["mamba_segments"]))
    assert n_checked == (len(ref_leaves) - per_block * (1 + bool(trailing))
                         + per_block * (n_seg * seg + trailing))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert count_params(tparams) == n_ref


def test_init_params_shapes_and_scales():
    cfg = reduced_config(get_config("zamba2-7b"))
    rcfg = ref_reduced_config(ref_get_config("zamba2-7b"))
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0), rcfg))
    for name, leaf in ref["mamba_segments"].items():
        if isinstance(leaf, dict):
            continue
        got = p["mamba_segments"][1][0][name]
        assert tuple(got.shape) == leaf.shape[2:], name
        assert got.dtype == (torch.float32 if leaf.dtype == jnp.float32
                             else torch.bfloat16), name
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert count_params(p) == n_ref
    w = p["mamba_segments"][0][1]["in_proj"].float()
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["shared_attn"]["mlp"]["wo"],
                       p["shared_attn"]["mlp"]["wo"])
    state = init_decode_state(cfg, 3, 20, "cpu")
    ref_state = {k: tuple(v) for k, v in
                 ref_zamba_state_shape(rcfg, 3, 20).items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == ref_state


def test_full_size_parameter_count():
    """zamba2-7b at full width and depth: the reference's 6,751,130,832
    parameters, reckoned from the port's block shapes on the meta device."""
    cfg = get_config("zamba2-7b")
    from repro_torch.models import layers as L
    from repro_torch.models import ssm, transformer

    meta = torch.device("meta")
    gen = None

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        return tree.numel()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "_normal", lambda g, shape, scale, device:
                   torch.empty(shape, dtype=L.DTYPE, device=meta))
        mamba = numel(ssm.init_mamba2_block(gen, cfg, meta))
        shared = numel(transformer.init_block(gen, cfg, meta))
        embed = numel(L.init_embedding(gen, cfg, meta))
    total = embed + cfg.n_layers * mamba + shared + cfg.d_model
    assert total == 6_751_130_832


# -- the serving entry point ---------------------------------------------

PLAN_TRIALS = 1_000
SC = dict(arch="zamba2-7b", batch=2, gen_tokens=4)


def _fewer_trials(cls):
    return lambda **kw: cls(**{**kw, "n_trials": PLAN_TRIALS})


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "SimulatedPlanner",
                   _fewer_trials(ref_serve.SimulatedPlanner))
        mp.setattr(port_serve, "SimulatedPlanner",
                   _fewer_trials(port_serve.SimulatedPlanner))
        ref = ref_serve.run_serving(ref_serve.ServeConfig(**SC))
        port = port_serve.run_serving(port_serve.ServeConfig(**SC),
                                      device="cpu")
    return ref, port


def test_run_serving_makes_the_reference_plan(served):
    ref, port = served
    assert port["generated"].shape == ref["generated"].shape == (2, 4)
    vocab = reduced_config(get_config("zamba2-7b")).vocab_size
    assert ((port["generated"] >= 0) & (port["generated"] < vocab)).all()
    assert port["sojourn_best_B"] == ref["sojourn_best_B"]
    pol, want = port["policy"], ref["policy"]
    assert (pol.kind, pol.quantile, pol.hedge_fraction) == (
        want.kind, want.quantile, want.hedge_fraction)
    for b, w in ref["sojourn_by_B"].items():
        for k in ("mean", "p99", "p999"):
            assert port["sojourn_by_B"][b][k] == pytest.approx(w[k], rel=1e-5)
    assert port["backend"] == "cpu"


def test_generate_hybrid_end_to_end():
    cfg = reduced_config(get_config("zamba2-7b"))
    params = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 18),
                            generator=torch.Generator().manual_seed(4))
    gen = port_serve.generate(cfg, params, prompts, gen_tokens=5, max_len=24)
    assert gen.tokens.shape == (3, 5)
    again = port_serve.generate(cfg, params, prompts, gen_tokens=5, max_len=24)
    assert torch.equal(gen.tokens, again.tokens)
    for i in range(5):
        seq = torch.cat([prompts, gen.tokens[:, :i]], dim=1)
        logits, _ = prefill(cfg, params, {"tokens": seq}, 24)
        top2 = logits[:, -1].float().topk(2).values
        sure = (top2[:, 0] - top2[:, 1]) > ATOL
        assert torch.equal(logits[:, -1].argmax(-1)[sure], gen.tokens[sure, i])


def test_main_serves_the_hybrid_arch(served, capsys):
    calls = []

    def fake_run(sc, device=None):
        calls.append((sc, device))
        return served[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_serve, "run_serving", fake_run)
        port_serve.main(["--arch", "zamba2-7b", "--device", "cpu"])
    (sc, device), = calls
    assert (sc.arch, device) == ("zamba2-7b", "cpu")
    assert "load-aware p99-optimal B*" in capsys.readouterr().out
