"""Whisper (the audio family) of the port against the reference's, on the
CPU: reduced whisper-medium (2 + 2 layers, d 128, 2 heads of 64, frontend
dim 32, LayerNorm, GELU, biases, tied embeddings), from the reference's
parameters through ``params_from_reference`` with every bias and norm
scale set to seeded values (as ``tests/test_torch_models.py`` does), on
40 frames.

* ``encode``: within 4e-2 of the reference's (LayerNorm'd outputs of
  order 1; a few bf16 ulps).
* ``decode_train`` on the reference's encoder output: logits within 4e-2.
* ``decode_step`` from caches built by the reference's functions (the
  cross cache from the reference's ``_cross_kv`` of each layer at [0, 40)
  of a 64-slot cache), four steps with ``cross_len`` = 40: logits within
  4e-2 and the self cache within 0.1 + 5e-2 |ref|; and the port's step
  logits equal its own ``decode_train`` on the same tokens within 4e-2.
* ``lm.decode_step`` keeps the reference's rule ``cross_len = cache_len``
  (a defect of the reference, ROADMAP C): the port's logits equal the
  reference's ``lm.decode_step`` within 4e-2 at cache_len 1-3, and differ
  from a step over all 40 frames; at cache_len 0 the port raises.
* ``init_decode_state``'s keys and shapes are the reference's; ``prefill``
  raises ``NotImplementedError`` in both packages, and so does
  ``run_serving``.
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
from repro.models import decode_step as ref_lm_decode_step
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import whisper as RW
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch.serve import ServeConfig, run_serving
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models import whisper as W

ARCH = "whisper-medium"
ATOL = 4e-2
CACHE_TOL = dict(atol=0.1, rtol=5e-2)
B, T, MAX_LEN, STEPS = 2, 40, 64, 4


def _seeded(tree, seed=0):
    """Every bias and norm scale of the tree set to seeded values."""
    rng = np.random.default_rng(seed)

    def visit(d):
        for name, a in d.items():
            if isinstance(a, dict):
                visit(a)
            elif name.startswith("b") and name != "blocks":
                d[name] = (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
            elif name in ("scale", "bias"):
                base = 1.0 if name == "scale" else 0.0
                d[name] = (base + 0.1 * rng.standard_normal(a.shape)
                           ).astype(a.dtype)
    out = jax.tree.map(np.array, tree)
    visit(out)
    return out


@pytest.fixture(scope="module")
def model():
    rcfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    tree = _seeded(ref_init_params(jax.random.PRNGKey(0), rcfg))
    frames = np.random.default_rng(1).standard_normal(
        (B, T, cfg.frontend_dim)).astype(np.float32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, STEPS))
    return (rcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_reference(cfg, tree, device="cpu"), frames, toks)


@pytest.fixture(scope="module")
def encoded(model):
    rcfg, cfg, rparams, tparams, frames, _ = model
    renc = RW.encode(rcfg, Shard.local(), rparams, jnp.asarray(frames))
    return renc, W.encode(cfg, tparams, torch.from_numpy(frames))


def _close(port, ref, tol=ATOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


def test_whisper_params_layout(model):
    _, cfg, _, tparams, _, _ = model
    assert set(tparams) == {"frontend", "embed", "enc_blocks", "enc_norm",
                            "dec_blocks", "dec_norm"}
    assert len(tparams["enc_blocks"]) == len(tparams["dec_blocks"]) == 2
    assert {"ln_cross", "cross"} <= set(tparams["dec_blocks"][0])
    assert "unembed" not in tparams["embed"]  # tied


def test_encode_matches_reference(encoded):
    renc, enc = encoded
    assert enc.shape == renc.shape == (B, T, 128)
    _close(enc, renc)


def test_decode_train_matches_reference(model, encoded):
    rcfg, cfg, rparams, tparams, _, toks = model
    renc, _ = encoded
    rl = RW.decode_train(rcfg, Shard.local(), rparams, jnp.asarray(toks),
                         renc)
    enc = torch.from_numpy(np.asarray(renc, np.float32)).to(torch.bfloat16)
    tl = W.decode_train(cfg, tparams, torch.as_tensor(toks), enc)
    assert tl.shape == rl.shape == (B, STEPS, cfg.vocab_size)
    _close(tl, rl)


def _caches(rcfg, cfg, rparams, tparams, renc):
    """Both packages' decode caches, the cross half from the reference's
    ``_cross_kv`` of each layer at [0, T)."""
    rstate = ref_init_decode_state(rcfg, B, MAX_LEN)
    ck, cv = [], []
    for i in range(rcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], rparams["dec_blocks"])
        k, v = RW._cross_kv(rcfg, lp, renc)
        ck.append(k)
        cv.append(v)
    ck, cv = jnp.stack(ck), jnp.stack(cv)
    rstate["cross_k"] = rstate["cross_k"].at[:, :, :T].set(ck)
    rstate["cross_v"] = rstate["cross_v"].at[:, :, :T].set(cv)
    tstate = init_decode_state(cfg, B, MAX_LEN, "cpu")
    for name in ("cross_k", "cross_v"):
        tstate[name].copy_(torch.from_numpy(
            np.asarray(rstate[name], np.float32)).to(torch.bfloat16))
    return rstate, tstate


@pytest.fixture(scope="module")
def steps(model, encoded):
    """STEPS ``whisper.decode_step`` calls over all T frames in both
    packages, fed the same tokens."""
    rcfg, cfg, rparams, tparams, _, toks = model
    rstate, tstate = _caches(rcfg, cfg, rparams, tparams, encoded[0])
    rlog, tlog = [], []
    for i in range(STEPS):
        rl, rstate = RW.decode_step(rcfg, Shard.local(), rparams, rstate,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i), jnp.int32(T))
        tl, tstate = W.decode_step(cfg, tparams, tstate,
                                   torch.as_tensor(toks[:, i:i + 1]), i, T)
        rlog.append(rl)
        tlog.append(tl)
    return rlog, tlog, rstate, tstate


def test_decode_step_matches_reference(steps):
    rlog, tlog, rstate, tstate = steps
    for rl, tl in zip(rlog, tlog):
        assert tl.shape == rl.shape == (B, 1, 512)
        _close(tl, rl)
    for name in ("self_k", "self_v"):
        port = tstate[name].float().numpy()
        np.testing.assert_allclose(
            port[:, :, :STEPS], np.asarray(rstate[name], np.float32)[
                :, :, :STEPS], **CACHE_TOL)
        assert not port[:, :, STEPS:].any()


def test_decode_step_agrees_with_decode_train(model, encoded, steps):
    _, cfg, _, tparams, _, toks = model
    _, tlog, _, _ = steps
    enc = torch.from_numpy(np.asarray(encoded[0], np.float32)).to(
        torch.bfloat16)
    full = W.decode_train(cfg, tparams, torch.as_tensor(toks), enc)
    _close(torch.cat(tlog, dim=1), full.float().numpy())


def test_lm_decode_step_keeps_the_reference_cross_len_rule(model, encoded,
                                                          steps):
    rcfg, cfg, rparams, tparams, _, toks = model
    rstate, tstate = _caches(rcfg, cfg, rparams, tparams, encoded[0])
    with pytest.raises(ValueError, match="cross_len"):
        decode_step(cfg, tparams, tstate, torch.as_tensor(toks[:, :1]), 0)
    _, tlog_all, _, _ = steps
    for i in range(1, STEPS):
        tok = toks[:, i:i + 1]
        rl, rstate = ref_lm_decode_step(rcfg, Shard.local(), rparams, rstate,
                                        jnp.asarray(tok), jnp.int32(i))
        tl, tstate = decode_step(cfg, tparams, tstate, torch.as_tensor(tok), i)
        _close(tl, rl)
        # i frames, not T: the step over all frames differs
        assert (tl.float() - tlog_all[i].float()).abs().max() > 10 * ATOL


def test_init_decode_state_and_prefill(model):
    rcfg, cfg, rparams, tparams, _, toks = model
    rstate = ref_init_decode_state(rcfg, B, MAX_LEN)
    tstate = init_decode_state(cfg, B, MAX_LEN, "cpu")
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        k: tuple(v.shape) for k, v in rstate.items()}
    assert all(v.dtype == torch.bfloat16 for v in tstate.values())
    batch = {"tokens": toks}
    with pytest.raises(NotImplementedError):
        ref_prefill(rcfg, Shard.local(), rparams,
                    {"tokens": jnp.asarray(toks)}, MAX_LEN)
    with pytest.raises(NotImplementedError, match="audio"):
        prefill(cfg, tparams, batch, MAX_LEN)
    with pytest.raises(NotImplementedError, match="audio"):
        run_serving(ServeConfig(arch=ARCH, batch=2, gen_tokens=2),
                    device="cpu")
