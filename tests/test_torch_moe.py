"""The MoE family of the port against the reference's, on the CPU:
olmoe-1b-7b (64 experts, top-8) and deepseek-moe-16b (64 routed top-6, 2
shared, dense layer 0), with the configs of all ten architectures.

* Every field of each of the ten configs, and of its ``reduced_config``,
  equals the reference's (nested sub-configs as dicts); the full configs'
  parameter counts (on the meta device) lie in the reference's published
  ranges (``tests/test_models_smoke.py``) and equal the reference's
  ``count_params``; ``active_params`` equals the reference's.
* ``router_capacity`` equals the reference's.
* ``apply_moe`` at a capacity with no overflow (capacity factor 8, as the
  reference's own test uses), on the reference's parameters: in float32
  within 1e-5, in bfloat16 within 2e-2 (a few bf16 ulps of outputs of
  order 1); the aux loss within 1e-6; the shared experts (deepseek) too.
* At overflow, the port equals a per-token loop that drops only the
  assignments ranked >= capacity in their expert (ranks in flat token-major
  order, the stable sort's): float32 within 1e-5.
* The reference's defect: at the seed and shapes of ROADMAP C (reduced
  olmoe, ``init_moe(PRNGKey(0))``, x (2, 16, d) bf16 from PRNGKey(1),
  capacity 2) the reference differs from the loop exactly at the rank-0
  tokens of the overflowing experts (by more than 0.5) and agrees
  elsewhere within 1e-2; the port agrees with the loop everywhere.
* Reduced olmoe and deepseek-moe (4 layers, d 128, 8 experts, top-2,
  capacity factor 8), from the reference's parameters through
  ``params_from_reference`` (both unembeddings are untied: the final norm
  scale is set near 1/4, as ``tests/test_torch_dense_configs.py`` does for
  qwen2.5-14b): prefill and four greedy decode steps give the
  reference's logits within 4e-2 (the dense family's tolerance) and its
  KV caches within 0.1 + 5e-2 |ref|.  Both run in bf16, and where two
  gate probabilities nearly tie the two roundings can order them
  differently (a routing flip), after which the two models part by design:
  so the port routes each call to the reference's experts (its own
  probabilities weight them), and every token whose own top-k set would
  differ must be a near-tie, a margin below 1e-2 between the reference's
  k-th and (k+1)-th probability.  ``apply_moe``'s own routing is held
  above.
* The device rule, and ``train_loss`` and ``Trainer.step`` running on
  the four families (their training is held against the reference in
  ``tests/test_torch_train_families.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import Shard
from repro.models import count_params as ref_count_params
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.lm import active_params as ref_active_params
import repro.models.moe as ref_moe
import repro_torch.models.moe as port_moe
from repro.models.moe import apply_moe as ref_apply_moe
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import router_capacity as ref_router_capacity
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.convert import _tree, params_from_reference
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import (active_params, count_params, decode_step,
                                init_params, prefill, train_loss)
from repro_torch.models.moe import apply_moe, route, router_capacity

ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]
F32_TOL, BF16_TOL, AUX_TOL = 1e-5, 2e-2, 1e-6
ATOL = 4e-2
UNTIED_FINAL_SCALE = 0.25
CACHE_TOL = dict(atol=0.1, rtol=5e-2)
B, S, MAX_LEN, STEPS = 2, 24, 48, 4
# the published ranges of tests/test_models_smoke.py
PUBLISHED = {
    "command-r-plus-104b": (100e9, 108e9),
    "qwen2-0.5b": (0.4e9, 0.55e9),
    "qwen2.5-14b": (14e9, 15.5e9),
    "granite-34b": (32e9, 36e9),
    "olmoe-1b-7b": (6.5e9, 7.5e9),
    "deepseek-moe-16b": (15.5e9, 17.5e9),
    "zamba2-7b": (6.0e9, 7.6e9),
    "internvl2-76b": (68e9, 76e9),
    "whisper-medium": (0.7e9, 0.9e9),
    "xlstm-350m": (0.3e9, 0.5e9),
}


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_matches_reference(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    assert _fields(cfg) == _fields(rcfg)
    assert _fields(reduced_config(cfg)) == _fields(ref_reduced_config(rcfg))
    assert cfg.head_dim == rcfg.head_dim


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_full_size_param_counts(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    n = count_params(cfg)
    lo, hi = PUBLISHED[arch]
    assert lo <= n <= hi
    assert n == ref_count_params(rcfg)
    assert active_params(cfg) == ref_active_params(rcfg)


@pytest.mark.parametrize("n_tokens", [1, 8, 48, 8192])
def test_router_capacity(n_tokens):
    for arch in ARCHS:
        for cfg, rcfg in ((get_config(arch), ref_get_config(arch)),
                          (reduced_config(get_config(arch)),
                           ref_reduced_config(ref_get_config(arch)))):
            assert (router_capacity(cfg.moe, n_tokens)
                    == ref_router_capacity(rcfg.moe, n_tokens))


def _moe_cfgs(arch, **moe):
    rcfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    return (dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, **moe)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)))


def _moe_case(arch, dtype, seed=0, shape=(2, 16), **moe):
    """Reference MoE parameters (cast to ``dtype``) and input, each in both
    packages."""
    rcfg, cfg = _moe_cfgs(arch, **moe)
    rp = ref_init_moe(jax.random.PRNGKey(seed), rcfg)
    if dtype == jnp.float32:
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1),
                          shape + (rcfg.d_model,)).astype(dtype)
    tp = _tree(jax.tree.map(np.asarray, rp), "cpu")
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return rcfg, cfg, rp, x, tp, xt


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_moe_matches_reference_without_overflow(arch, dtype):
    rcfg, cfg, rp, x, tp, xt = _moe_case(arch, dtype, capacity_factor=8.0)
    ry, raux = ref_apply_moe(rcfg, Shard.local(), rp, x)
    y, aux = apply_moe(cfg, tp, xt)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    assert abs(float(aux) - float(raux)) <= AUX_TOL
    assert ("shared" in tp) == (arch == "deepseek-moe-16b")


def _loop_moe(rcfg, rp, x, cap):
    """Per-token loop in float32: the reference's routing, each token's
    assignments in order, ranked within their expert in flat token-major
    order; the ranks >= cap dropped.  Returns (y (T, d), rank-0 token of
    each expert, the experts that overflowed, assignments dropped)."""
    moe = rcfg.moe
    xf = np.asarray(x.astype(jnp.float32)).reshape(-1, rcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(rp["router"],
                                                          jnp.float32), -1)
    gw, ge = jax.lax.top_k(probs, moe.top_k)
    gw, ge = np.asarray(gw / gw.sum(-1, keepdims=True)), np.asarray(ge)
    wg, wu, wo = (np.asarray(rp[k], np.float32)
                  for k in ("wi_gate", "wi_up", "wo"))
    out = np.zeros_like(xf)
    rank = np.zeros(moe.n_experts, int)
    rank0, over, dropped = {}, set(), 0
    for t in range(xf.shape[0]):
        for j in range(moe.top_k):
            e = int(ge[t, j])
            r, rank[e] = rank[e], rank[e] + 1
            rank0.setdefault(e, t)
            if r >= cap:
                over.add(e)
                dropped += 1
                continue
            g, u = xf[t] @ wg[e], xf[t] @ wu[e]
            out[t] += gw[t, j] * ((g / (1 + np.exp(-g)) * u) @ wo[e])
    return out, rank0, over, dropped


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_overflow_drops_only_ranks_past_capacity(cap):
    rcfg, cfg, rp, x, tp, xt = _moe_case("olmoe-1b-7b", jnp.float32, seed=3)
    want, _, over, dropped = _loop_moe(rcfg, rp, x, cap)
    assert over and dropped > 0
    y, _ = apply_moe(cfg, tp, xt, capacity=cap)
    np.testing.assert_allclose(y.reshape(want.shape).numpy(), want,
                               atol=F32_TOL, rtol=F32_TOL)


def test_reference_overwrites_rank0_of_overflowing_experts():
    """ROADMAP C, "Defects of the reference": the reference's overflow
    scatter sends every dropped assignment to slot expert * cap + 0 with
    value 0, which (XLA's CPU backend scatters in order) overwrites the
    expert's rank-0 token."""
    rcfg, cfg, rp, x, tp, xt = _moe_case("olmoe-1b-7b", jnp.bfloat16,
                                         n_shared=0)
    want, rank0, over, _ = _loop_moe(rcfg, rp, x, 2)
    ry, _ = ref_apply_moe(rcfg, Shard.local(), rp, x, capacity=2)
    ref_err = np.abs(np.asarray(ry.astype(jnp.float32)).reshape(want.shape)
                     - want).max(axis=-1)
    hit = sorted({rank0[e] for e in over})
    assert hit == [0, 1, 2, 4, 5, 6, 9]
    assert sorted(np.nonzero(ref_err > 0.5)[0].tolist()) == hit
    assert np.delete(ref_err, hit).max() <= 1e-2
    y, _ = apply_moe(cfg, tp, xt, capacity=2)
    assert np.abs(y.float().reshape(want.shape).numpy() - want).max() <= 1e-2


def _untied_scale(tree):
    """The final norm scale near 1/4, as ``tests/test_torch_dense_configs.py``
    sets it for an untied unembedding (scale d^-0.5): the logits then lie
    within about +-1, where 4e-2 is about ten bf16 ulps, not within +-3.3,
    where it is under three."""
    scale = tree["final_norm"]["scale"]
    tree["final_norm"]["scale"] = (UNTIED_FINAL_SCALE * (
        1 + 0.1 * np.random.default_rng(1).standard_normal(scale.shape))
    ).astype(scale.dtype)
    return tree


def _ref_recorder(calls, orig):
    """The reference's ``apply_moe``, keeping each call's top-k experts
    (T, k) and its margin between the k-th and (k+1)-th gate probability
    (through an ordered callback: it runs under scan)."""
    def apply(cfg, shard, params, x, capacity=None):
        xf = x.reshape(-1, cfg.d_model).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ params["router"], axis=-1)
        srt, top = jax.lax.top_k(probs, cfg.moe.top_k + 1)
        k = cfg.moe.top_k
        jax.debug.callback(
            lambda e, m: calls.append((np.asarray(e), np.asarray(m))),
            top[:, :k], srt[:, k - 1] - srt[:, k], ordered=True)
        return orig(cfg, shard, params, x, capacity)
    return apply


def _forced_route(forced, flips):
    """The port's ``route`` with the reference's experts: the port's own
    probabilities, their top-k taken at the reference's experts (the next
    recorded call) and renormalised; each token whose own top-k set
    differs is a flip, kept with the reference's margin there."""
    def forced_route(moe, router, xt):
        probs, _, own = route(moe, router, xt)
        ref_e, margin = next(forced)
        gate_e = torch.from_numpy(ref_e.astype(np.int64))
        gate_w = torch.gather(probs, -1, gate_e)
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        flip = (np.sort(own.numpy(), -1) != np.sort(ref_e, -1)).any(-1)
        flips.extend(margin[flip].tolist())
        return probs, gate_w, gate_e
    return forced_route


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Prefill + STEPS greedy decode steps in both packages at capacity
    factor 8, each fed the reference's greedy token.  Every MoE call of the
    port routes to the reference's experts for that call (the weights are
    the port's own probabilities there), so a bf16 near-tie that the two
    roundings order differently (a routing flip) does not send the two
    models apart; the flips are kept, each with the reference's margin."""
    rcfg, cfg = _moe_cfgs(request.param, capacity_factor=8.0)
    tree = _untied_scale(jax.tree.map(
        np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg)))
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_reference(cfg, tree, device="cpu")
    shard = Shard.local()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    rcalls, flips = [], []
    ref_logits, port_logits, ref_toks = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "apply_moe",
                   _ref_recorder(rcalls, ref_moe.apply_moe))
        rl, rs = ref_prefill(rcfg, shard, rparams,
                             {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
        ref_logits.append(rl)
        step = jax.jit(lambda p, s, t, c: ref_decode_step(rcfg, shard, p, s,
                                                          t, c))
        for i in range(STEPS):
            ref_toks.append(np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None])
            rl, rs = step(rparams, rs, jnp.asarray(ref_toks[-1], jnp.int32),
                          jnp.int32(S + i))
            ref_logits.append(rl)
        jax.effects_barrier()
    n_moe = cfg.n_layers - cfg.moe.first_layer_dense
    assert len(rcalls) == n_moe * (1 + STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_moe, "route", _forced_route(iter(rcalls), flips))
        tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)},
                         MAX_LEN)
        port_logits.append(tl)
        for i in range(STEPS):
            tl, ts = decode_step(cfg, tparams, ts,
                                 torch.as_tensor(ref_toks[i]), S + i)
            port_logits.append(tl)
    return cfg, tparams, ref_logits, port_logits, rs, ts, flips


def test_moe_routing_flips_are_near_ties(runs):
    *_, flips = runs
    assert all(m < 1e-2 for m in flips), flips


def test_moe_logits_match_reference(runs):
    cfg, tparams, ref_logits, port_logits, *_ = runs
    assert ("dense_block" in tparams) == cfg.moe.first_layer_dense
    assert len(tparams["blocks"]) == cfg.n_layers - cfg.moe.first_layer_dense
    for ref, port in zip(ref_logits, port_logits):
        ref = np.asarray(ref, np.float32)
        assert port.shape == ref.shape and port.dtype == torch.bfloat16
        np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                                   rtol=0)


def test_moe_kv_cache_matches_reference(runs):
    *_, rs, ts, _ = runs
    for name in ("k", "v"):
        ref = np.asarray(rs[name], np.float32)
        port = ts[name].float().numpy()
        assert port.shape == ref.shape
        np.testing.assert_allclose(port[:, :, : S + STEPS],
                                   ref[:, :, : S + STEPS], **CACHE_TOL)
        assert not port[:, :, S + STEPS:].any()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-76b",
                                  "xlstm-350m", "whisper-medium"])
def test_device_rule_and_no_training(arch):
    cfg = reduced_config(get_config(arch))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(torch.Generator(), cfg)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert next(iter(params["embed"].values())).device.type == "cpu"
    trainer = Trainer(TrainerConfig(arch=arch, steps=1, seq_len=32,
                                    global_batch=8), device="cpu")
    batch = trainer._device_batch(trainer.pipeline.batch_for(0, 0, 4))
    loss, met = train_loss(cfg, params, batch)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert (float(met["aux"]) > 0) == (cfg.family == "moe")
    step_loss, completion, decision = trainer.step(0)
    assert np.isfinite(step_loss) and np.isfinite(completion)
    assert decision.kind == "ok" and int(trainer.opt_state["step"]) == 1
