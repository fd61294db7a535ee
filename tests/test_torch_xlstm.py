"""xLSTM (the ssm family, xlstm-350m) of the port against the reference's,
on the CPU.

* ``mlstm_chunked`` (chunk 16, with and without an initial state) and
  ``mlstm_sequential`` against the reference's ``mlstm_chunked`` and
  ``mlstm_sequential``, and ``mlstm_decode_step`` from a carried state
  against the reference's: float32, within 1e-5 x (1 + |ref|).
  ``mlstm_chunked`` raises unless the chunk divides the sequence.
* The sLSTM block (and its decode from a carried state) on the
  reference's parameters: bf16 outputs within 4e-2, float32 states within
  1e-3 x (1 + |ref|).
* Reduced xlstm (d 128, 2 heads, dk 16, dv 128, chunk 16; 4 blocks: one
  segment of 3 mLSTM + 1 sLSTM, and a 6-block variant with 2 trailing
  mLSTM blocks), from the reference's parameters through
  ``params_from_reference`` (norm scales seeded; the untied final norm
  near 1/4 as ``tests/test_torch_dense_configs.py`` does): prefill of 32
  tokens (two chunks) and four greedy decode steps give the reference's
  logits within 4e-2 of the reference's, and every state key within
  5e-2 x (1 + |ref|) of the reference's run on XLA's SSE4.2 code
  (``tests/_xlstm_pinned_reference.py``, in a subprocess fed the same
  tokens).  XLA's CPU ``tanh``, ``exp``, ``rsqrt`` and logistic functions
  give other last bits on AVX2 hosts (FMAs inside them), whether jitted or
  run op by op, and the sLSTM recurrence carries them into the 6-block
  model's trailing state: on an AMD EPYC host the native reference's
  ``t_conv`` moved 0.035 x (1 + |ref|) from the SSE4.2 one, and the port's
  lay 0.0575 from the native one and 0.030 from the SSE4.2 one.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import os
import subprocess
import sys

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
from repro.models import xlstm as RX
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import _tree, params_from_reference
from repro_torch.models import decode_step, prefill
from repro_torch.models import xlstm as X
from repro_torch.models.lm import _xlstm_layout

ARCH = "xlstm-350m"
F32_TOL = 1e-5
ATOL = 4e-2
STATE_TOL = 5e-2
UNTIED_FINAL_SCALE = 0.25
B, S, MAX_LEN, STEPS = 2, 32, 64, 4


def _mlstm_inputs(seed, b=2, s=64, h=2, dk=16, dv=32):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (2.0 + rng.standard_normal((b, s, h))).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _close(port, ref, tol):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy() if torch.is_tensor(port) else port
    assert port.shape == ref.shape
    assert (np.abs(port - ref) <= tol * (1 + np.abs(ref))).all(), (
        np.abs(port - ref).max())


def _state(seed):
    """A carried (C, n, m) from the reference's sequential run."""
    xs = _mlstm_inputs(seed, s=8)
    _, st = RX.mlstm_sequential(*map(jnp.asarray, xs))
    return st


@pytest.mark.parametrize("initial", [False, True])
def test_mlstm_chunked_matches_reference(initial):
    xs = _mlstm_inputs(0)
    rinit = _state(1) if initial else None
    tinit = (tuple(torch.from_numpy(np.array(a)) for a in rinit)
             if initial else None)
    rh, rst = RX.mlstm_chunked(*map(jnp.asarray, xs), 16, rinit)
    sh, sst = RX.mlstm_sequential(*map(jnp.asarray, xs), rinit)
    th, tst = X.mlstm_chunked(*map(torch.from_numpy, xs), 16, tinit)
    ph, pst = X.mlstm_sequential(*map(torch.from_numpy, xs), tinit)
    for got in ((th, tst), (ph, pst)):
        for want in ((rh, rst), (sh, sst)):
            _close(got[0], want[0], F32_TOL)
            for a, r in zip(got[1], want[1]):
                _close(a, r, F32_TOL)
    with pytest.raises(ValueError, match="chunk"):
        X.mlstm_chunked(*map(torch.from_numpy, xs), 24)


def test_mlstm_decode_step_matches_reference():
    rst = _state(2)
    q, k, v, i_pre, f_pre = (a[:, 0] for a in _mlstm_inputs(3, s=1))
    rh, rnew = RX.mlstm_decode_step(rst, *map(jnp.asarray,
                                              (q, k, v, i_pre, f_pre)))
    th, tnew = X.mlstm_decode_step(
        tuple(torch.from_numpy(np.array(a)) for a in rst),
        *map(torch.from_numpy, (q, k, v, i_pre, f_pre)))
    _close(th, rh, F32_TOL)
    for a, r in zip(tnew, rnew):
        _close(a, r, F32_TOL)


def test_slstm_block_matches_reference():
    rcfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    rp = RX.init_slstm_block(jax.random.PRNGKey(5), rcfg)
    tp = _tree(jax.tree.map(np.asarray, rp), "cpu")
    x = jax.random.normal(jax.random.PRNGKey(6), (2, 12, rcfg.d_model)
                          ).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    ry, rst = RX.apply_slstm_block(rcfg, Shard.local(), rp, x)
    ty, tst = X.apply_slstm_block(cfg, tp, xt)
    _close(ty, ry, ATOL)
    for name in ("c", "n", "m", "h"):
        _close(tst[name], rst[name], 1e-3)
    ry2, rst2 = RX.apply_slstm_decode(rcfg, Shard.local(), rp, x[:, :1], rst)
    ty2, tst2 = X.apply_slstm_decode(cfg, tp, xt[:, :1], tst)
    _close(ty2, ry2, ATOL)
    for name in ("c", "n", "m", "h"):
        _close(tst2[name], rst2[name], 1e-3)


def _seeded_scales(tree, seed=0):
    rng = np.random.default_rng(seed)

    def visit(d):
        for name, a in d.items():
            if isinstance(a, dict):
                visit(a)
            elif name == "scale":
                d[name] = (1 + 0.1 * rng.standard_normal(a.shape)
                           ).astype(a.dtype)
    out = jax.tree.map(np.array, tree)
    visit(out)
    scale = out["final_norm"]["scale"]
    out["final_norm"]["scale"] = (UNTIED_FINAL_SCALE * scale).astype(
        scale.dtype)
    return out


def _pinned_reference_state(tmp_path, n_layers, toks, steps):
    """The reference's state after the same prompt and decode tokens, run
    on XLA's SSE4.2 code in a subprocess."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, n_layers=n_layers, tokens=toks, steps=np.stack(steps))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=SSE4_2").strip()
    helper = os.path.join(os.path.dirname(__file__),
                          "_xlstm_pinned_reference.py")
    out = subprocess.run([sys.executable, helper, str(src), str(dst)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module", params=[4, 6])
def runs(request, tmp_path_factory):
    """Prefill + STEPS greedy decode steps in both packages, each fed the
    reference's greedy token; and the reference's state from the same
    tokens on XLA's SSE4.2 code."""
    n = request.param
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                               n_layers=n)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), n_layers=n)
    tree = _seeded_scales(ref_init_params(jax.random.PRNGKey(0), rcfg))
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_reference(cfg, tree, device="cpu")
    shard = Shard.local()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    rl, rs = ref_prefill(rcfg, shard, rparams,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    tl, ts = prefill(cfg, tparams, {"tokens": torch.as_tensor(toks)}, MAX_LEN)
    ref_logits, port_logits, states = [rl], [tl], [(rs, dict(ts))]
    step = jax.jit(lambda p, s, t, c: ref_decode_step(rcfg, shard, p, s, t, c))
    fed = []
    for i in range(STEPS):
        tok = np.array(jnp.argmax(ref_logits[-1][:, -1], axis=-1))[:, None]
        fed.append(tok)
        rl, rs = step(rparams, rs, jnp.asarray(tok, jnp.int32),
                      jnp.int32(S + i))
        tl, ts = decode_step(cfg, tparams, ts, torch.as_tensor(tok), S + i)
        ref_logits.append(rl)
        port_logits.append(tl)
    pinned = _pinned_reference_state(tmp_path_factory.mktemp("xlstm"), n,
                                     toks, fed)
    return cfg, tparams, ref_logits, port_logits, pinned, ts


def test_xlstm_layout_and_params(runs):
    cfg, tparams, *_ = runs
    n_seg, m_per, trailing = _xlstm_layout(cfg)
    assert (n_seg, m_per, trailing) == (1, 3, cfg.n_layers - 4)
    assert len(tparams["mlstm_segments"]) == n_seg
    assert len(tparams["mlstm_segments"][0]) == m_per
    assert len(tparams["slstm_blocks"]) == n_seg
    assert len(tparams.get("mlstm_trailing", [])) == trailing


def test_xlstm_logits_match_reference(runs):
    _, _, ref_logits, port_logits, _, _ = runs
    for ref, port in zip(ref_logits, port_logits):
        ref = np.asarray(ref, np.float32)
        assert port.shape == ref.shape and port.dtype == torch.bfloat16
        np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                                   rtol=0)


def test_xlstm_state_matches_reference(runs):
    cfg, _, _, _, rs, ts = runs
    assert set(ts) == set(rs)
    want = {"m_c", "m_n", "m_m", "m_conv", "s_c", "s_n", "s_m", "s_h"}
    if cfg.n_layers > 4:
        want |= {"t_c", "t_n", "t_m", "t_conv"}
    assert set(ts) == want
    for name in sorted(ts):
        assert tuple(ts[name].shape) == tuple(rs[name].shape), name
        _close(ts[name], rs[name], STATE_TOL)
