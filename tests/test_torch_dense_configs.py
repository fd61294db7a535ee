"""The three head-dim-128 dense configs of the port against the reference's,
on the CPU: qwen2.5-14b (GQA 40 / 8, QKV bias, untied), command-r-plus-104b
(96 / 8, parallel attention + FFN, LayerNorm, tied) and granite-34b (MQA
48 / 1, GELU with MLP biases, LayerNorm, tied).

* Every field of each config, and of its ``reduced_config``, equals the
  reference's; the full configs have head dim 128.
* Reduced models (4 layers; qwen2.5-14b d_model 128 over 2 heads of 64
  and 2 KV heads, command-r 384 over 6 / 2, granite 768 over 12 / 1), from
  the reference's parameters through ``params_from_reference`` (biases
  and norm scales set to seeded values, as ``tests/test_torch_models.py``
  does): prefill and four greedy decode steps give the reference's logits
  within 4e-2 absolute, the dense family's tolerance, and the KV caches
  within 0.1 + 5e-2 |ref|.  qwen2.5-14b's unembedding is untied (scale
  d^-0.5, logits of unit scale and more): its final norm scale is set to
  1/4, as ``tests/test_torch_zamba.py`` does, which brings the logits
  within about +-1, where 4e-2 is about ten bfloat16 ulps (measured at most
  1.3e-2 then; the tied models' logits lie within +-2.2 and agree within
  1.6e-2).
* granite-34b's ``train_loss`` and every gradient leaf (MQA, GELU, MLP
  biases, LayerNorm with bias, tied embeddings) against
  ``jax.value_and_grad`` of the reference's, with
  ``tests/test_torch_train_grad.py``'s tolerances: the loss within 2e-3
  (measured 3.1e-4), each leaf within 5e-2 of its largest reference
  gradient and in relative L2 norm (measured at most 2.4e-2).
* ``run_serving(arch=...)`` on the CPU makes the reference's fleet plan
  for each (``tests/test_torch_serve.py``'s comparison, at 1,000 planner
  trials in both packages), and serves tokens of the right shape.
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
from repro.models import train_loss as ref_train_loss
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import decode_step, prefill
from test_torch_models import _with_bias

ARCHS = ["qwen2.5-14b", "command-r-plus-104b", "granite-34b"]
ATOL = 4e-2
CACHE_TOL = dict(atol=0.1, rtol=5e-2)
LOSS_TOL, GRAD_TOL = 2e-3, 5e-2
UNTIED_FINAL_SCALE = 0.25
B, S, MAX_LEN, STEPS = 2, 24, 48, 4
PLAN_TRIALS = 1_000


def _build(arch):
    """Reduced configs and the reference's parameters as numpy, biases and
    norm scales seeded (and, untied, the final norm scale near 1/4)."""
    rcfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    tree = _with_bias(ref_init_params(jax.random.PRNGKey(0), rcfg))
    if not cfg.tie_embeddings:
        scale = tree["final_norm"]["scale"]
        tree["final_norm"]["scale"] = (UNTIED_FINAL_SCALE * (
            1 + 0.1 * np.random.default_rng(1).standard_normal(scale.shape))
        ).astype(scale.dtype)
    return rcfg, cfg, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert arch in ARCH_IDS
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for mine, theirs in ((cfg, rcfg), (reduced_config(cfg),
                                       ref_reduced_config(rcfg))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.head_dim == theirs.head_dim
    assert cfg.head_dim == 128


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Prefill + STEPS greedy decode steps in both packages, each fed the
    reference's greedy token."""
    rcfg, cfg, tree = _build(request.param)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_reference(cfg, tree, device="cpu")
    shard = Shard.local()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, MAX_LEN)
    ref_logits, port_logits = [rl], [tl]
    step = jax.jit(lambda p, s, t, c: ref_decode_step(rcfg, shard, p, s, t, c))
    for i in range(STEPS):
        tok = np.array(jnp.argmax(ref_logits[-1][:, -1], axis=-1))[:, None]
        rl, rs = step(rparams, rs, jnp.asarray(tok, jnp.int32),
                      jnp.int32(S + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), S + i)
        ref_logits.append(rl)
        port_logits.append(tl)
    return ref_logits, port_logits, rs, ts


def test_logits_match_reference(runs):
    ref_logits, port_logits, _, _ = runs
    for ref, port in zip(ref_logits, port_logits):
        ref = np.asarray(ref, np.float32)
        assert port.shape == ref.shape and port.dtype == torch.bfloat16
        np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                                   rtol=0)


def test_kv_cache_matches_reference(runs):
    *_, rs, ts = runs
    for name in ("k", "v"):
        ref = np.asarray(rs[name], np.float32)
        port = ts[name].float().numpy()
        assert port.shape == ref.shape
        np.testing.assert_allclose(port[:, :, : S + STEPS],
                                   ref[:, :, : S + STEPS], **CACHE_TOL)
        assert not port[:, :, S + STEPS:].any()


def test_granite_gradients_match_reference():
    rcfg, cfg, tree = _build("granite-34b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 64))
    batch = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train_loss(rcfg, Shard.local(), p, b), has_aux=True))
    (rloss, _), rgrad = fn(jax.tree.map(jnp.asarray, tree),
                           jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(cfg, tree, device="cpu")
    (loss, _), grad = value_and_grad(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL
    rgrad = params_from_reference(cfg, jax.tree.map(np.asarray, rgrad),
                                  device="cpu")
    assert "unembed" not in grad["embed"]
    for i, (layer, rlayer) in enumerate(zip(grad["blocks"], rgrad["blocks"])):
        for group in layer:
            for name, g in layer[group].items():
                r = rlayer[group][name].float()
                g = g.float()
                scale = r.abs().max().item()
                assert scale > 0, (i, group, name)
                assert (g - r).abs().max().item() <= GRAD_TOL * scale
                assert ((g - r).norm() / r.norm()).item() <= GRAD_TOL
    for group in ("embed", "final_norm"):
        for name, g in grad[group].items():
            r = rgrad[group][name].float()
            assert ((g.float() - r).norm() / r.norm()).item() <= GRAD_TOL


@pytest.fixture(scope="module")
def reference_plans():
    """The reference's ``run_serving`` for each arch, and the port's, at
    PLAN_TRIALS planner trials."""
    def fewer(cls):
        return lambda **kw: cls(**{**kw, "n_trials": PLAN_TRIALS})

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "SimulatedPlanner",
                   fewer(ref_serve.SimulatedPlanner))
        mp.setattr(port_serve, "SimulatedPlanner",
                   fewer(port_serve.SimulatedPlanner))
        for arch in ARCHS:
            sc = dict(arch=arch, batch=2, gen_tokens=3)
            out[arch] = (ref_serve.run_serving(ref_serve.ServeConfig(**sc)),
                         port_serve.run_serving(port_serve.ServeConfig(**sc),
                                                device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_makes_the_reference_plan(reference_plans, arch):
    ref, port = reference_plans[arch]
    assert port["sojourn_best_B"] == ref["sojourn_best_B"]
    pol, want = port["policy"], ref["policy"]
    assert (pol.kind, pol.quantile, pol.hedge_fraction) == (
        want.kind, want.quantile, want.hedge_fraction)
    for b, w in ref["sojourn_by_B"].items():
        for k in ("mean", "p99", "p999"):
            assert port["sojourn_by_B"][b][k] == pytest.approx(w[k], rel=1e-5)
    for b, w in ref["latency_by_B"].items():
        for k in ("mean", "p99"):
            assert port["latency_by_B"][b][k] == pytest.approx(w[k], rel=1e-6)
    vocab = reduced_config(get_config(arch)).vocab_size
    assert port["generated"].shape == ref["generated"].shape == (2, 3)
    assert ((port["generated"] >= 0) & (port["generated"] < vocab)).all()
