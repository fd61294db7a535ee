"""Training of the MoE, VLM, audio and xLSTM families: the port's
``train_loss`` and its gradients against the reference's, on the CPU.

* The cases, from the reference's parameters through
  ``params_from_reference``: reduced olmoe-1b-7b and deepseek-moe-16b (4
  layers, d 128, 8 experts top-2, deepseek's dense layer 0 kept and two
  shared experts) at capacity factor 8, so no expert overflows (the
  reference's overflow scatter is defective, ROADMAP C); reduced
  internvl2-76b (4 layers, 8 patch slots ahead of 32 text tokens);
  reduced whisper-medium (2 + 2 layers, 128 frames, 16 decoder tokens);
  reduced xlstm-350m at 4 blocks (one segment of 3 mLSTM blocks ending in
  its sLSTM) and at 8 (a segment and 4 trailing mLSTM blocks), 32
  positions (two chunks of 16).  Biases and norm scales are set to seeded
  values and an untied unembedding's final norm scale near 1/4, as the
  serving tests (``tests/test_torch_moe.py``, ``test_torch_vlm.py``,
  ``test_torch_whisper.py``, ``test_torch_xlstm.py``) set them.  Batches
  come from the port's ``TokenPipeline``, bit-equal to the reference's.
* ``train_loss`` and the gradient of every parameter leaf against
  ``jax.value_and_grad`` of the reference's jitted ``train_loss``, with
  ``tests/test_torch_train_grad.py``'s bf16 tolerances: the loss and the
  aux loss within 2e-3 (measured at most 7.2e-4, olmoe); each leaf within
  5e-2 of its largest reference gradient and in relative L2 norm
  (measured at most 3.8e-2 and 2.5e-2, deepseek-moe).  One kind of leaf
  is held otherwise: a key bias (whisper's ``bk``) has an exact gradient
  of 0 (q . b_k is the same for every key, and the softmax ignores it),
  so both sides hold rounding residue, held within 5e-2 of the largest
  reference gradient of the same attention's bq and bv.  The xLSTM's
  mLSTM input-gate biases are seeded near -8 (``_quiet_input_gates``):
  at the reference's init (bias 0) the normaliser max(|q . n|, e^-m)
  divides by near-cancelling sums q . n, and the reference's own bf16
  gradient then lies up to 0.50 (4 blocks) and 1.77 (8 blocks) of a
  leaf's largest from its float32 gradient, so no bf16 tolerance could
  tell a right gradient from a wrong one.  With the bias near -8, e^-m
  sets the normaliser: that spread falls to at most 0.05 and 0.08, and
  every xLSTM leaf is held to the same 5e-2 as the other families (the
  port's gap measured at most 2.6e-2 and 3.2e-2).  In bf16 the MoE
  layers of the port are routed to the reference's experts call by call
  (``tests/test_torch_moe.py``'s recorder; the router still takes its
  gradient through the port's own gate probabilities), and every token
  whose own top-k set differs must be a near-tie, a margin below 1e-2
  (measured 2 flips at most, margins up to 2.9e-3).  Run in float32 end
  to end, the loss agrees within 1e-5 and every leaf within 1e-4 of its
  largest (measured at most 4.8e-7 and 8.6e-6, xlstm; 3.1e-6
  elsewhere): the gradient algebra is the reference's, and the bf16 gaps
  are rounding.
* The leaves a detached or missing path would leave at exactly 0 are
  nonzero: the MoE router and experts (and deepseek's shared experts), the
  VLM projector, whisper's cross attention (its ``wq``, ``wk``, ``wv`` and
  the encoder's attention behind it) and every sLSTM block's recurrent
  ``r``; every gradient is finite.
* At overflow (capacity 1-3), ``apply_moe``'s gradients (router, experts,
  input) equal those of a per-token float32 loop that drops only the
  assignments ranked >= capacity, within 1e-5 of each one's largest.
* ``FlashAttentionFn`` at ``causal=False`` with sq != skv (whisper's cross
  attention) and sq = skv (its encoder) against autograd through
  ``flash_attention_plain`` and ``jax.vjp`` of the reference's
  ``chunked_gqa_attend(causal=False)``: 5e-5 (float32) and 5e-2 (bf16) x
  (1 + |ref|).
* ``chip_smoke.py``'s hold of ``FlashAttentionFn`` at whisper's shapes
  (1,500 keys, a ragged last tile), scaled to each tensor's size: the
  bf16 kernel's arithmetic within 5e-2 x (min(1, RMS) + |ref|) of the
  plain version in float32, the gradients of autograd through the bf16
  plain version, and an output without the last key read past it.
* The audio and vlm batches (``global_batch``, ``batch_for`` over B,
  ``shard_for_coord``) equal the reference's ``TokenPipeline``'s bit for
  bit, dtypes included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
import repro_torch.models.moe as port_moe
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import ShapeCell as RefShapeCell
from repro.core import ReplicationPlan as RefPlan
from repro.data import TokenPipeline as RefPipeline
from repro.models import Shard
from repro.models import init_params as ref_init_params
from repro.models import train_loss as ref_train_loss
from repro.models.moe import init_moe as ref_init_moe
from repro.models.transformer import chunked_gqa_attend
from repro_torch.configs import ShapeCell, get_config, reduced_config
from repro_torch.convert import _tree, params_from_reference
from repro_torch.core import ReplicationPlan
from repro_torch.data import TokenPipeline
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_plain)
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import train_loss
from repro_torch.models.moe import apply_moe, route
from test_torch_attention_hopper import wgmma_numerics
from test_torch_models import _with_bias
from test_torch_moe import _forced_route, _ref_recorder, _untied_scale
from test_torch_train_grad import _paths
from test_torch_whisper import _seeded
from test_torch_xlstm import _seeded_scales

LOSS_TOL = 2e-3
GRAD_TOL = 5e-2
F32_LOSS_TOL, F32_GRAD_TOL = 1e-5, 1e-4
FLIP_MARGIN = 1e-2
ATT_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
B = 2
# case -> (arch, layers or None, sequence length of the batch)
CASES = {
    "olmoe-1b-7b": ("olmoe-1b-7b", None, 32),
    "deepseek-moe-16b": ("deepseek-moe-16b", None, 32),
    "internvl2-76b": ("internvl2-76b", None, 40),
    "whisper-medium": ("whisper-medium", None, 128),
    "xlstm-350m-4": ("xlstm-350m", 4, 32),
    "xlstm-350m-8": ("xlstm-350m", 8, 32),
}


def _configs(arch, n_layers=None):
    """(reference config, port config), reduced; MoE at capacity factor 8;
    xLSTM at ``n_layers`` blocks."""
    rcfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    if cfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return rcfg, cfg


def _reference_tree(rcfg):
    """The reference's parameters as numpy, biases and norm scales seeded
    as the family's serving test seeds them."""
    tree = ref_init_params(jax.random.PRNGKey(0), rcfg)
    if rcfg.family == "audio":
        return _seeded(tree)
    if rcfg.family == "ssm":
        return _quiet_input_gates(_seeded_scales(tree))
    if rcfg.family == "vlm":
        return _untied_scale(_with_bias(tree))
    return _untied_scale(jax.tree.map(np.asarray, tree))


def _quiet_input_gates(tree, bias=-8.0, seed=7):
    """Every mLSTM block's input-gate bias (``b_if[..., 0]``) set to
    ``bias`` + N(0, 0.1^2), so that e^-m, not the near-cancelling q . n,
    sets the normaliser (see the module docstring)."""
    rng = np.random.default_rng(seed)
    for key in ("mlstm_segments", "mlstm_trailing"):
        if key in tree:
            b_if = tree[key]["b_if"]
            b_if[..., 0] = bias + 0.1 * rng.standard_normal(b_if.shape[:-1])
    return tree


def _case(name, dtype=None):
    """(reference config, port config, numpy tree, numpy batch); with
    ``dtype`` every leaf of the tree cast to it."""
    arch, n_layers, seq = CASES[name]
    rcfg, cfg = _configs(arch, n_layers)
    tree = _reference_tree(rcfg)
    if dtype is not None:
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), tree)
    batch = TokenPipeline(cfg, ShapeCell("t", seq, B, "train"),
                          seed=1).global_batch(0)
    return rcfg, cfg, tree, batch


def _value_and_grads(rcfg, cfg, tree, batch):
    """Both packages' (loss, metrics, gradient tree), the reference's
    gradients converted to the port's layout; the port's MoE layers routed
    to the reference's experts.  Returns (..., flips, port params)."""
    calls, flips = [], []
    with pytest.MonkeyPatch.context() as mp:
        if cfg.moe is not None:
            mp.setattr(ref_moe, "apply_moe",
                       _ref_recorder(calls, ref_moe.apply_moe))
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: ref_train_loss(rcfg, Shard.local(), p, b),
            has_aux=True))
        (rloss, rmet), rgrad = fn(jax.tree.map(jnp.asarray, tree),
                                  jax.tree.map(jnp.asarray, batch))
        jax.effects_barrier()
    params = params_from_reference(cfg, tree, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if cfg.moe is not None:
            n_moe = cfg.n_layers - cfg.moe.first_layer_dense
            # the forward's calls, layer by layer; the reference's backward
            # recomputes each layer (jax.checkpoint) and records it again
            assert len(calls) == 2 * n_moe
            mp.setattr(port_moe, "route",
                       _forced_route(iter(calls[:n_moe]), flips))
        (loss, met), grad = value_and_grad(cfg, params, tbatch)
    rgrad = params_from_reference(cfg, jax.tree.map(np.asarray, rgrad),
                                  device="cpu")
    return (float(rloss), {k: float(v) for k, v in rmet.items()}, rgrad,
            float(loss), {k: float(v) for k, v in met.items()}, grad, flips,
            params)


@pytest.fixture(scope="module", params=list(CASES))
def grads(request):
    rcfg, cfg, tree, batch = _case(request.param)
    return (request.param, cfg, batch) + _value_and_grads(rcfg, cfg, tree,
                                                          batch)


@pytest.fixture(scope="module")
def grads32(grads):
    """``grads``' case with every leaf of the tree cast to float32."""
    rcfg, cfg, tree, batch = _case(grads[0], np.float32)
    return _value_and_grads(rcfg, cfg, tree, batch)


def _bias_scale(rgrad, path):
    """The largest reference gradient of the attention's bq and bv, beside
    the key bias at ``path``."""
    node = rgrad
    for key in path.strip("/").split("/")[:-1]:
        node = node[int(key)] if isinstance(node, list) else node[key]
    return max(node[n].abs().max().item() for n in ("bq", "bv"))


def test_train_loss_matches_reference(grads):
    name, cfg, batch, rloss, rmet, _, loss, met, _, flips, params = grads
    assert abs(loss - rloss) <= LOSS_TOL, (loss, rloss)
    assert abs(met["loss"] - rmet["loss"]) <= LOSS_TOL
    assert abs(met["aux"] - rmet["aux"]) <= LOSS_TOL
    assert (met["aux"] > 0) == (cfg.family == "moe")
    assert all(m < FLIP_MARGIN for m in flips), flips
    if cfg.moe is None:
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        again, _ = train_loss(cfg, params, tbatch)
        assert again.dtype == torch.float32 and float(again) == loss


def test_every_gradient_leaf_matches_reference(grads):
    name, cfg, *_, rgrad, _, _, grad, _, params = grads
    ref_leaves, port_leaves = list(_paths(rgrad)), list(_paths(grad))
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    assert [p for p, _ in port_leaves] == [p for p, _ in _paths(params)]
    for (path, r), (_, g), (_, p) in zip(ref_leaves, port_leaves,
                                         _paths(params)):
        assert g.dtype == p.dtype and g.shape == p.shape, path
        assert bool(torch.isfinite(g.float()).all()), path
        r, g = r.float(), g.float()
        if path.endswith("/bk"):
            assert (g - r).abs().max().item() <= GRAD_TOL * _bias_scale(
                rgrad, path), path
            continue
        scale = r.abs().max().item()
        assert scale > 0, path
        assert (g - r).abs().max().item() <= GRAD_TOL * scale, path
        assert ((g - r).norm() / r.norm()).item() <= GRAD_TOL, path


def _get(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


# the leaves each family reaches only through its own new path
REACHED = {
    "moe": ["blocks/{i}/moe/router", "blocks/{i}/moe/wi_gate",
            "blocks/{i}/moe/wi_up", "blocks/{i}/moe/wo"],
    "vlm": ["projector/w", "blocks/{i}/attn/wq", "blocks/{i}/attn/wk"],
    "audio": ["dec_blocks/{i}/cross/wq", "dec_blocks/{i}/cross/wk",
              "dec_blocks/{i}/cross/wv", "enc_blocks/{i}/attn/wq",
              "enc_blocks/{i}/attn/wk", "frontend"],
    "ssm": ["slstm_blocks/{i}/r", "slstm_blocks/{i}/w_in",
            "mlstm_segments/0/{i}/w_q", "mlstm_segments/0/{i}/w_k"],
}


def test_new_paths_reach_their_leaves(grads):
    name, cfg, *_, grad, _, _ = grads
    n = {"moe": cfg.n_layers - cfg.moe.first_layer_dense if cfg.moe else 0,
         "vlm": cfg.n_layers, "audio": cfg.n_layers,
         "ssm": 1}[cfg.family]
    for i in range(n):
        for path in REACHED[cfg.family]:
            leaf = _get(grad, path.format(i=i))
            assert leaf.float().abs().max().item() > 0, path.format(i=i)
    if cfg.moe is not None and cfg.moe.n_shared:
        assert grad["blocks"][0]["moe"]["shared"]["wi_gate"].abs().max() > 0


def test_gradients_match_reference_in_float32(grads32):
    rloss, _, rgrad, loss, _, grad, _, _ = grads32
    assert abs(loss - rloss) <= F32_LOSS_TOL, (loss, rloss)
    for (path, r), (_, g) in zip(_paths(rgrad), _paths(grad)):
        assert g.dtype == torch.float32, path
        scale = (_bias_scale(rgrad, path) if path.endswith("/bk")
                 else r.abs().max().item())
        assert (g - r).abs().max().item() <= F32_GRAD_TOL * scale, path


def _loop_moe_torch(moe, params, xt, cap):
    """Per-token float32 loop with the port's routing: each token's k
    assignments in order, ranked within their expert in flat token-major
    order, the ranks >= cap dropped (weight kept, output not added).
    Differentiable.  Returns (T, d)."""
    _, gate_w, gate_e = route(moe, params["router"], xt)
    rank = [0] * moe.n_experts
    rows = []
    for t in range(xt.shape[0]):
        out = torch.zeros_like(xt[t])
        for j in range(moe.top_k):
            e = int(gate_e[t, j])
            r, rank[e] = rank[e], rank[e] + 1
            if r >= cap:
                continue
            g = xt[t] @ params["wi_gate"][e]
            u = xt[t] @ params["wi_up"][e]
            out = out + gate_w[t, j] * ((torch.nn.functional.silu(g) * u)
                                        @ params["wo"][e])
        rows.append(out)
    return torch.stack(rows)


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_moe_overflow_gradient_matches_per_token_loop(cap):
    rcfg, cfg = _configs("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25, aux_loss_weight=0.0))
    rp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      ref_init_moe(jax.random.PRNGKey(3), rcfg))
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    dy = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def grads_of(fn):
        params = {k: v.requires_grad_(True) for k, v in
                  _tree(rp, "cpu").items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(params, xt)
        leaves = [params[k] for k in ("router", "wi_gate", "wi_up", "wo")]
        return y.detach(), torch.autograd.grad(
            y, leaves + [xt], torch.from_numpy(dy).reshape(y.shape))

    y, g = grads_of(lambda p, xt: apply_moe(cfg, p, xt, capacity=cap)[0])
    want, wg = grads_of(lambda p, xt: _loop_moe_torch(
        cfg.moe, p, xt.reshape(-1, cfg.d_model), cap))
    probs, _, gate_e = route(cfg.moe, torch.from_numpy(np.array(rp["router"])),
                             torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert int(torch.bincount(gate_e.reshape(-1)).max()) > cap  # overflow
    np.testing.assert_allclose(y.reshape(want.shape).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(g, wg):
        scale = b.abs().max().item()
        assert scale > 0
        assert (a.reshape(b.shape) - b).abs().max().item() <= 1e-5 * scale


def _att_arrays(seed, sq, skv, h=4, kv=2, d=64, b=2):
    rng = np.random.default_rng(seed)
    make = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [make(b, sq, h, d), make(b, skv, kv, d), make(b, skv, kv, d),
            make(b, sq, h, d)]


def _close(got, want, tol):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol * (1 + want.abs())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(12, 40), (40, 40), (40, 24)])
def test_flash_fn_non_causal_matches_the_references_autodiff(dtype, sq, skv):
    arrays = _att_arrays(sq * 100 + skv, sq, skv)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: chunked_gqa_attend(q, k, v, causal=False),
                     jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, False, 0)
    out.backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_plain(*plain, causal=False).backward(do)
    for a, w, p in zip(leaves, want, plain):
        assert a.grad.dtype == dtype and a.grad.shape == a.shape
        assert _close(a.grad, torch.from_numpy(np.array(w, np.float32)),
                      ATT_TOL[dtype])
        assert _close(a.grad, p.grad, ATT_TOL[dtype])
    fwd = chunked_gqa_attend(jq, jk, jv, causal=False)
    assert _close(out.detach(), torch.from_numpy(np.array(fwd, np.float32)),
                  ATT_TOL[dtype])


def _reading(got, want):
    """``chip_smoke.py``'s reading of a FlashAttentionFn hold: the largest
    |got - want| / (min(1, RMS(want)) + |want|)."""
    got, want = got.float(), want.float()
    floor = min(1.0, want.square().mean().sqrt().item())
    return ((got - want).abs() / (floor + want.abs())).max().item()


@pytest.mark.parametrize("sq", [187, 1500])
def test_flash_hold_passes_the_kernel_and_fails_a_skipped_key(sq):
    """``chip_smoke.py``'s hold of FlashAttentionFn at whisper's
    non-causal shapes (1,500 keys, 23 tiles of 64 and 28 over; 2 heads,
    batch 1): the bf16 kernel's arithmetic (``wgmma_numerics``) reads
    within 5e-2 of the plain version in float32, the gradients within
    5e-2 of autograd through the bf16 plain version, and an output
    without the last key past 5e-2."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in
                   _att_arrays(sq, sq, 1500, h=2, kv=2, b=1))
    want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=False)
    kernel = wgmma_numerics(q, k, v, causal=False, q_offset=0, block_k=64)
    assert _reading(kernel, want32) <= ATT_TOL[torch.bfloat16]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FlashAttentionFn.apply(*leaves, False, 0).backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_plain(*plain, causal=False).backward(do)
    for a, p in zip(leaves, plain):
        assert _reading(a.grad, p.grad) <= ATT_TOL[torch.bfloat16]
    cut = flash_attention_plain(q, k[:, :-1], v[:, :-1], causal=False)
    assert _reading(cut, want32) > ATT_TOL[torch.bfloat16]


def _pipes(arch, seq, gb=8, seed=3):
    rcfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    return (RefPipeline(rcfg, RefShapeCell("t", seq, gb, "train"), seed=seed),
            TokenPipeline(cfg, ShapeCell("t", seq, gb, "train"), seed=seed))


def _equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch,seq", [("whisper-medium", 64),
                                      ("whisper-medium", 24),
                                      ("internvl2-76b", 40)])
def test_audio_and_vlm_batches_equal_the_references(arch, seq):
    ref, port = _pipes(arch, seq)
    for step in (0, 9):
        _equal(ref.global_batch(step), port.global_batch(step))
        for n_b in (1, 2, 4, 8):
            for bid in range(n_b):
                _equal(ref.batch_for(step, bid, n_b),
                       port.batch_for(step, bid, n_b))
    plan, rplan = ReplicationPlan(8, 4), RefPlan(n_data=8, n_batches=4)
    for w in range(8):
        _equal(ref.shard_for_coord(5, w, rplan),
               port.shard_for_coord(5, w, plan))
    g = port.global_batch(0)
    floats = [k for k in g if g[k].dtype == np.float32]
    assert floats == (["frames"] if arch.startswith("whisper")
                      else ["patch_embeds"])
