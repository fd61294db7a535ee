"""The vlm family of the port (internvl2-76b's backbone) against the
reference's, on the CPU.

* Reduced internvl2 (4 layers, d 256, 4 heads over 2 KV heads of 64, 8
  patch slots of frontend dim 32), from the reference's parameters through
  ``params_from_reference`` (biases and norm scales seeded as
  ``tests/test_torch_models.py`` does; the unembedding is untied, so the
  final norm scale is set near 1/4 as ``tests/test_torch_dense_configs.py``
  does for qwen2.5-14b): prefill of 24 tokens behind the 8 projected patch
  embeddings, then four greedy decode steps at cache_len = 8 + 24 + i, past
  the prompt (an off-by-n_patches position shows only there): logits
  within 4e-2, the dense family's tolerance, and the KV cache within
  0.1 + 5e-2 |ref| over the 8 + 24 + 4 positions written, zero beyond.
* ``generate`` counts the patch slots against ``max_len``, and decodes
  after them.
* ``run_serving(arch="internvl2-76b")`` on the CPU makes the reference's
  fleet plan (``tests/test_torch_serve.py``'s comparison, at 1,000
  planner trials in both packages) and serves tokens of the right shape;
  its patch embeddings are drawn from the prompts' generator.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

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
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch.serve import generate
from repro_torch.models import decode_step, prefill
from test_torch_models import _with_bias

ARCH = "internvl2-76b"
ATOL = 4e-2
CACHE_TOL = dict(atol=0.1, rtol=5e-2)
UNTIED_FINAL_SCALE = 0.25
B, S, MAX_LEN, STEPS = 2, 24, 48, 4
PLAN_TRIALS = 1_000


@pytest.fixture(scope="module")
def model():
    rcfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    tree = _with_bias(ref_init_params(jax.random.PRNGKey(0), rcfg))
    scale = tree["final_norm"]["scale"]
    tree["final_norm"]["scale"] = (UNTIED_FINAL_SCALE * (
        1 + 0.1 * np.random.default_rng(1).standard_normal(scale.shape))
    ).astype(scale.dtype)
    return rcfg, cfg, tree, params_from_reference(cfg, tree, device="cpu")


@pytest.fixture(scope="module")
def runs(model):
    """Prefill with patch embeddings + STEPS greedy decode steps in both
    packages, each fed the reference's greedy token."""
    rcfg, cfg, tree, tparams = model
    rparams = jax.tree.map(jnp.asarray, tree)
    shard = Shard.local()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    patches = rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim)
                                  ).astype(np.float32)
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32),
                          "patch_embeds": jnp.asarray(patches)}, MAX_LEN)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks),
                                    "patch_embeds": torch.from_numpy(patches)},
                     MAX_LEN)
    ref_logits, port_logits = [rl], [tl]
    step = jax.jit(lambda p, s, t, c: ref_decode_step(rcfg, shard, p, s, t, c))
    base = cfg.n_patches + S
    for i in range(STEPS):
        tok = np.array(jnp.argmax(ref_logits[-1][:, -1], axis=-1))[:, None]
        rl, rs = step(rparams, rs, jnp.asarray(tok, jnp.int32),
                      jnp.int32(base + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), base + i)
        ref_logits.append(rl)
        port_logits.append(tl)
    return cfg, ref_logits, port_logits, rs, ts


def test_vlm_params_carry_the_projector(model):
    rcfg, cfg, tree, tparams = model
    assert tuple(tparams["projector"]["w"].shape) == (cfg.frontend_dim,
                                                      cfg.d_model)
    assert len(tparams["blocks"]) == cfg.n_layers
    assert cfg.n_patches == 8 and cfg.frontend == "patch"


def test_vlm_logits_match_reference(runs):
    _, ref_logits, port_logits, _, _ = runs
    for ref, port in zip(ref_logits, port_logits):
        ref = np.asarray(ref, np.float32)
        assert port.shape == ref.shape == (B, 1, 512)
        np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                                   rtol=0)


def test_vlm_kv_cache_matches_reference(runs):
    cfg, _, _, rs, ts = runs
    n = cfg.n_patches + S + STEPS
    for name in ("k", "v"):
        ref = np.asarray(rs[name], np.float32)
        port = ts[name].float().numpy()
        assert port.shape == ref.shape
        np.testing.assert_allclose(port[:, :, :n], ref[:, :, :n], **CACHE_TOL)
        assert not port[:, :, n:].any()


def test_generate_counts_the_patch_slots(model):
    _, cfg, _, tparams = model
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    patches = torch.randn((B, cfg.n_patches, cfg.frontend_dim), generator=g)
    with pytest.raises(ValueError, match="max_len"):
        generate(cfg, tparams, prompts, 4, S + 3, patches)
    gen = generate(cfg, tparams, prompts, 4, cfg.n_patches + S + 3, patches)
    logits, state = prefill(cfg, tparams, {"tokens": prompts,
                                           "patch_embeds": patches},
                            cfg.n_patches + S + 3)
    want = [logits[:, -1].argmax(-1, keepdim=True)]
    for i in range(3):
        logits, state = decode_step(cfg, tparams, state, want[-1],
                                    cfg.n_patches + S + i)
        want.append(logits[:, -1].argmax(-1, keepdim=True))
    assert torch.equal(gen.tokens, torch.cat(want, dim=1))


def test_run_serving_makes_the_reference_plan():
    def fewer(cls):
        return lambda **kw: cls(**{**kw, "n_trials": PLAN_TRIALS})

    sc = dict(arch=ARCH, batch=2, gen_tokens=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "SimulatedPlanner",
                   fewer(ref_serve.SimulatedPlanner))
        mp.setattr(port_serve, "SimulatedPlanner",
                   fewer(port_serve.SimulatedPlanner))
        ref = ref_serve.run_serving(ref_serve.ServeConfig(**sc))
        port = port_serve.run_serving(port_serve.ServeConfig(**sc),
                                      device="cpu")
    assert port["sojourn_best_B"] == ref["sojourn_best_B"]
    pol, want = port["policy"], ref["policy"]
    assert (pol.kind, pol.quantile, pol.hedge_fraction) == (
        want.kind, want.quantile, want.hedge_fraction)
    for b, w in ref["sojourn_by_B"].items():
        for k in ("mean", "p99", "p999"):
            assert port["sojourn_by_B"][b][k] == pytest.approx(w[k], rel=1e-5)
    assert port["generated"].shape == ref["generated"].shape == (2, 3)
    assert ((port["generated"] >= 0) & (port["generated"] < 512)).all()
