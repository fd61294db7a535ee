"""The port's training forward and backward against the reference's, on
the CPU.

* ``train_loss`` and the gradient of every parameter leaf of reduced
  qwen2-0.5b (4 layers, d_model 128, 2 heads of 64, GQA kept) and of
  reduced zamba2-7b (4 layers, two segments of two Mamba-2 blocks and the
  shared block, 32 positions: two chunks of 16; and 5 layers, with a
  trailing block, 21 positions: one ragged chunk), from the reference's
  parameters through ``params_from_reference`` (biases, norm scales and
  the Mamba-2 blocks' small parameters set to seeded values, as
  ``tests/test_torch_models.py`` and ``tests/test_torch_zamba.py`` do),
  against ``jax.value_and_grad`` of the reference's ``train_loss``
  (jitted, as its trainer runs it).  Both run in bfloat16 and round at
  different points (XLA keeps float32 across fused chains).  Tolerances:
  the loss within 2e-3 (measured 2.3e-4 on a loss of 6.26; zamba2 5.8e-4
  and 1.1e-3); each leaf within 5e-2 of its largest reference gradient
  (measured at most 3.4e-2, on the key bias, whose exact gradient is 0:
  the softmax ignores a per-query shift of the logits; zamba2's other
  leaves at most 3.8e-2) and within 5e-2 in relative L2 norm (measured at most
  3.9e-2, the same leaf; 2e-2 elsewhere).  Zamba2's per-head float32
  leaves (``a_log``, ``dt_bias``, ``d_skip``) sum one product a position,
  head and channel of bfloat16 activations, with cancellation (their
  gradients are 1e-4 of the matrices'), and are held within 0.25 of their
  largest and in relative L2 norm (measured at most 0.155 and 0.090, on
  the trailing block's ``a_log`` over 21 positions).  Run in
  float32 end to end (the same trees cast to float32, which both models
  follow), reduced zamba2's loss agrees within 1e-5 and every leaf within
  1e-4 of its largest (measured 4.8e-7 and 1.3e-5): the gradient algebra
  is the reference's, and the bfloat16 gaps are rounding.
* ``FlashAttentionFn``'s gradients against autograd through
  ``flash_attention_plain`` at head dims 64, 112 and 128, float32 and
  bfloat16, GQA, causal and not, within the attention tests' tolerances
  times (1 + |plain|): 5e-5 in float32 (measured 4.5e-7) and 5e-2 in
  bfloat16 (measured 0: on the CPU the two compute the same ops); and
  against ``jax.vjp`` of the reference's ``gqa_attend`` (the XLA twin its
  training forward runs) within the same tolerances.
* ``make_train_step`` with 1 and 2 micro-batches against the reference's:
  the loss within 2e-3 (measured 2.5e-4), the new parameters within 8e-3
  (measured 2.4e-3: a first AdamW step of lr 1e-3 moves an element by
  about 1e-3 either way, so a sign flip of a near-zero gradient moves it
  2e-3, and bf16's spacing at the parameters' scale adds up to 4e-3), the
  grad norm within 2% (measured 6e-4).
* The kernel wrappers without a backward (``flash_attention``,
  ``decode_attention``, ``ssd_scan``) raise ``RuntimeError`` with grad mode
  on and an input that requires grad, and run under ``torch.no_grad()``.
  ``SsdScanFn`` is held in ``tests/test_torch_ssd_grad.py``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import ShardingPolicy
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Shard
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import train_loss as ref_train_loss
from repro.optim import init as ref_opt_init
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_grad,
                                                 flash_attention_plain)
from repro_torch.kernels.ssm_scan import ssd_scan
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, value_and_grad)
from repro_torch.models import train_loss
from repro_torch.tree import tree_leaves
from test_torch_zamba import _build as _build_zamba

LOSS_TOL = 2e-3
GRAD_TOL = 5e-2  # of the leaf's largest reference gradient, and relative L2
SCALAR_TOL = 0.25  # zamba2's per-head float32 leaves (see the docstring)
SCALAR_LEAVES = ("a_log", "dt_bias", "d_skip")
F32_LOSS_TOL, F32_GRAD_TOL = 1e-5, 1e-4
ATT_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
PARAM_TOL = 8e-3
B, S = 4, 64


def _with_bias(tree, seed=0):
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
def model():
    rcfg = ref_reduced_config(ref_get_config("qwen2-0.5b"))
    cfg = reduced_config(get_config("qwen2-0.5b"))
    tree = _with_bias(ref_init_params(jax.random.PRNGKey(0), rcfg))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    return rcfg, cfg, tree, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _case(arch, dtype=np.float32):
    """(reference config, port config, numpy tree, batch) of a parametrised
    case: reduced qwen2-0.5b, or reduced zamba2-7b at 4 or 5 layers; with
    ``dtype`` float32 every leaf of the tree is cast to float32."""
    if arch == "qwen2-0.5b":
        rcfg = ref_reduced_config(ref_get_config(arch))
        cfg = reduced_config(get_config(arch))
        tree = _with_bias(ref_init_params(jax.random.PRNGKey(0), rcfg))
        b, s = B, S
    else:
        n_layers = int(arch.rsplit("-", 1)[1])
        rcfg, cfg, _, tree = _build_zamba(n_layers)
        b, s = 2, HYBRID_SEQ[n_layers]
    if dtype is not None:
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    batch = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    return rcfg, cfg, tree, batch


# zamba2 cases: layers -> positions (two chunks of 16; one ragged chunk)
HYBRID_SEQ = {4: 32, 5: 21}
ARCHS = ["qwen2-0.5b", "zamba2-7b-4", "zamba2-7b-5"]


def _value_and_grads(rcfg, cfg, tree, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train_loss(rcfg, Shard.local(), p, b), has_aux=True))
    (rloss, rmet), rgrad = fn(jax.tree.map(jnp.asarray, tree),
                              jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(cfg, tree, device="cpu")
    (loss, met), grad = value_and_grad(cfg, params, _torch_batch(batch))
    rgrad = params_from_reference(cfg, jax.tree.map(np.asarray, rgrad),
                                  device="cpu")
    return float(rloss), rmet, rgrad, float(loss), met, grad, params


@pytest.fixture(scope="module", params=ARCHS)
def grads(request):
    rcfg, cfg, tree, batch = _case(request.param, None)
    return (cfg, batch) + _value_and_grads(rcfg, cfg, tree, batch)


def test_train_loss_matches_reference(grads):
    cfg, batch, rloss, rmet, _, loss, met, _, params = grads
    assert abs(loss - rloss) <= LOSS_TOL, (loss, rloss)
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_TOL
    assert float(met["aux"]) == float(rmet["aux"]) == 0.0
    again, m = train_loss(cfg, params, _torch_batch(batch))
    assert again.dtype == torch.float32 and float(again) == loss


def test_every_gradient_leaf_matches_reference(grads):
    *_, rgrad, _, _, grad, params = grads
    ref_leaves, port_leaves = list(_paths(rgrad)), list(_paths(grad))
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    assert len(port_leaves) == len(tree_leaves(params))
    for (path, r), (_, g) in zip(ref_leaves, port_leaves):
        want = params_dtype(params, path)
        assert g.dtype == want, path
        tol = SCALAR_TOL if path.rsplit("/", 1)[1] in SCALAR_LEAVES else GRAD_TOL
        r, g = r.float(), g.float()
        scale = r.abs().max().item()
        assert scale > 0, path
        assert (g - r).abs().max().item() <= tol * scale, path
        assert ((g - r).norm() / r.norm()).item() <= tol, path


def params_dtype(params, path):
    node = params
    for key in path.strip("/").split("/"):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node.dtype


def test_attention_projections_get_gradients_through_attention(grads):
    """wq and wk reach the loss only through the attention weights: a
    detached attention output would leave them at exactly 0.  In zamba2
    the shared block's gradient sums its applications."""
    grad = grads[-2]
    layers = grad.get("blocks", [grad.get("shared_attn")])
    for layer in layers:
        for name in ("wq", "wk", "wv", "bq"):
            if name in layer["attn"]:
                assert layer["attn"][name].abs().max().item() > 0, name


@pytest.mark.parametrize("n_layers", [4, 5])
def test_scan_only_leaves_get_gradients_through_the_scan(n_layers):
    """Each Mamba-2 block's ``a_log``, ``dt_bias`` and ``conv_w``, and the
    x, B, C and dt columns of its ``in_proj``, reach the loss only through
    the SSD scan: a scan output detached from the graph would leave them
    at exactly 0.  ``d_skip`` and the z columns do not need the scan."""
    from repro_torch.models.ssm import _dims

    _, cfg, tree, batch = _case(f"zamba2-7b-{n_layers}", None)
    params = params_from_reference(cfg, tree, device="cpu")
    (_, _), grad = value_and_grad(cfg, params, _torch_batch(batch))
    d_inner, _ = _dims(cfg)
    blocks = [lp for seg in grad["mamba_segments"] for lp in seg]
    blocks += grad.get("mamba_trailing", [])
    assert len(blocks) == cfg.n_layers
    for lp in blocks:
        for name in ("a_log", "dt_bias", "conv_w"):
            assert lp[name].abs().max().item() > 0, name
        cols = lp["in_proj"][:, d_inner:]  # x, B, C and dt
        assert bool((cols.abs().amax(dim=0) > 0).all())


@pytest.mark.parametrize("n_layers", [4, 5])
def test_hybrid_gradients_match_reference_in_float32(n_layers):
    rcfg, cfg, tree, batch = _case(f"zamba2-7b-{n_layers}", np.float32)
    rloss, _, rgrad, loss, _, grad, _ = _value_and_grads(rcfg, cfg, tree,
                                                         batch)
    assert abs(loss - rloss) <= F32_LOSS_TOL, (loss, rloss)
    for (path, r), (_, g) in zip(_paths(rgrad), _paths(grad)):
        assert g.dtype == torch.float32, path
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() <= F32_GRAD_TOL * scale, path


def _att_inputs(d, dtype, seed, b=2, s=40, h=6, kv=2):
    rng = np.random.default_rng(seed)
    make = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return [make(b, s, h, d), make(b, s, kv, d), make(b, s, kv, d),
            make(b, s, h, d)]


def _close(got, want, tol):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol * (1 + want.abs())).all())


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fn_gradients_match_plain_autograd(d, dtype, causal):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _att_inputs(d, dtype, d))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = flash_attention_plain(*leaves, causal=causal)
    want.backward(do)
    got_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = FlashAttentionFn.apply(*got_leaves, causal, 0)
    got.backward(do)
    assert torch.equal(got.detach(), want.detach())
    for a, b in zip(got_leaves, leaves):
        assert a.grad.dtype == dtype and a.grad.shape == a.shape
        assert _close(a.grad, b.grad, ATT_TOL[dtype])


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grad_matches_the_references_autodiff(d, dtype):
    arrays = _att_inputs(d, dtype, 100 + d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: RL.gqa_attend(q, k, v, True), jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    got = flash_attention_grad(q, k, v, do, causal=True)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        assert _close(g, w, ATT_TOL[dtype])


def test_flash_grad_with_q_offset():
    q, k, v, do = (torch.from_numpy(a) for a in _att_inputs(64, None, 7))
    q, do = q[:, :16].contiguous(), do[:, :16].contiguous()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_plain(*leaves, causal=True, q_offset=24).backward(do)
    got = flash_attention_grad(q, k, v, do, causal=True, q_offset=24)
    for g, w in zip(got, leaves):
        assert _close(g, w.grad, ATT_TOL[torch.float32])


def test_wrappers_without_backward_refuse_grad():
    q = torch.randn(1, 4, 2, 64, requires_grad=True)
    k = torch.randn(1, 4, 1, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q[:, 0], k, k, 3)
    x = torch.ones((1, 5, 2, 16), requires_grad=True)
    bc = torch.ones((1, 5, 1, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, torch.ones((1, 5, 2)), torch.zeros(2), bc, bc,
                 torch.ones(2))
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
        assert decode_attention(q[:, 0], k, k, 3).shape == q[:, 0].shape
        y, _ = ssd_scan(x, torch.ones((1, 5, 2)), torch.zeros(2), bc, bc,
                        torch.ones(2))
        assert y.shape == x.shape


def test_hybrid_training_is_not_ported():
    """Named when the port refused hybrid training; it now holds that it
    does not: ``train_loss`` of reduced zamba2 gives the reference's loss,
    and only a family the port does not know raises (every one of the six
    trains)."""
    rcfg, cfg, tree, batch = _case("zamba2-7b-4", None)
    params = params_from_reference(cfg, tree, device="cpu")
    loss, met = train_loss(cfg, params, _torch_batch(batch))
    rloss, _ = jax.jit(lambda p, b: ref_train_loss(rcfg, Shard.local(), p, b))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL
    assert float(met["aux"]) == 0.0
    unknown = dataclasses.replace(cfg, family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        train_loss(unknown, params, _torch_batch(batch))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_reference(model, n_micro):
    rcfg, cfg, tree, batch = model
    lr = 1e-3
    rstep = jax.jit(ref_make_train_step(
        rcfg, ShardingPolicy(num_microbatches=n_micro)))
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = ref_opt_init(rparams)
    rnew, rnew_state, rmet = rstep(rparams, rstate,
                                   jax.tree.map(jnp.asarray, batch),
                                   jnp.float32(lr))
    params = params_from_reference(cfg, tree, device="cpu")
    state = opt_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    step = make_train_step(cfg, num_microbatches=n_micro)
    new, new_state, met = step(params, state, _torch_batch(batch),
                               torch.tensor(lr))
    assert abs(float(met["loss_total"]) - float(rmet["loss_total"])) <= LOSS_TOL
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=2e-2)
    assert int(new_state["step"]) == int(rnew_state["step"]) == 1
    want = params_from_reference(cfg, jax.tree.map(np.asarray, rnew),
                                 device="cpu")
    for (path, w), (_, g) in zip(_paths(want), _paths(new)):
        assert g.dtype == w.dtype, path
        assert (g.float() - w.float()).abs().max().item() <= PARAM_TOL, path


def test_micro_batches_average_the_gradient(model):
    """Two micro-batches give the mean of the two halves' gradients (float32
    accumulation), so the step equals one over the whole batch within
    bf16 rounding."""
    _, cfg, tree, batch = model
    params = params_from_reference(cfg, tree, device="cpu")
    (_, _), g_all = value_and_grad(cfg, params, _torch_batch(batch))
    halves = [{k: torch.from_numpy(v[i * 2:(i + 1) * 2]) for k, v in batch.items()}
              for i in range(2)]
    parts = [value_and_grad(cfg, params, h)[1] for h in halves]
    for a, b, c in zip(tree_leaves(g_all), *map(tree_leaves, parts)):
        mean = b.float() / 2 + c.float() / 2
        scale = a.float().abs().max().item()
        assert (mean - a.float()).abs().max().item() <= GRAD_TOL * scale


def test_prefill_and_decode_steps(model):
    _, cfg, tree, batch = model
    params = params_from_reference(cfg, tree, device="cpu")
    toks = torch.from_numpy(batch["tokens"][:, :16]).long()
    logits, state = make_prefill_step(cfg, max_len=20)(params, {"tokens": toks})
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert state["k"].shape[2] == 20
    tok = logits[:, -1].argmax(-1, keepdim=True)
    logits2, _ = make_decode_step(cfg)(params, state, tok, 16)
    assert logits2.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits2.float()).all())
