"""The port's attention against the reference's kernels, on the CPU.

On a CPU tensor ``repro_torch``'s ``flash_attention`` and
``decode_attention`` run their plain PyTorch versions.  They are held
against the reference's ``flash_attention`` / ``decode_attention`` in two
lanes, from the same numpy inputs:

* ``impl="pallas"``: the Pallas kernels in interpret mode, one small case
  each.  The kernels read their refs with ``pl.load``, which newer JAX
  releases dropped; the fixture below supplies it for the test's duration
  as the indexed read it was (``ref[idx]``).  The reference is unchanged.
* ``impl="xla"``: the reference's plain twins, over GQA ratios, dtypes,
  head dims and ragged lengths.

Tolerances are those of ``tests/test_kernels.py``: 5e-5 in float32 (the
lanes differ in summation order only) and 5e-2 in bfloat16 (where each
lane rounds q * scale, the logits and the weights to bfloat16 at its own
points; the Pallas kernel scales q in float32 and keeps p until the PV
product).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels import decode_attention as ref_decode
from repro.kernels import flash_attention as ref_flash
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture(scope="module")
def pallas_load():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
        yield


def _pair(x, dt):
    """The same values as a JAX array and a CPU tensor of one dtype."""
    jdt, tdt = DT[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port, ref, dt):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


def _qkv(seed, b, sq, skv, h, kv, d, dt):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return _pair(q, dt), _pair(k, dt), _pair(v, dt)


@pytest.mark.parametrize("q_offset", [0, 32])
def test_flash_plain_matches_pallas_interpret(pallas_load, q_offset):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, 1, 128, 128, 4, 2, 64, "f32")
    ref = ref_flash(jq, jk, jv, causal=True, q_offset=q_offset, impl="pallas")
    out = flash_attention(tq, tk, tv, causal=True, q_offset=q_offset)
    _close(out, ref, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,kv,d", [(4, 4, 64), (4, 2, 64), (7, 1, 64),
                                    (6, 2, 128), (4, 4, 112), (4, 2, 112)])
@pytest.mark.parametrize("sq,skv,causal", [(1, 37, True), (50, 50, True),
                                           (33, 97, True), (40, 72, False)])
def test_flash_plain_matches_xla(dt, h, kv, d, sq, skv, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, sq, skv, h, kv, d, dt)
    off = skv - sq if causal else 0  # the last query row sees every key
    ref = ref_flash(jq, jk, jv, causal=causal, q_offset=off, impl="xla")
    out = flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert out.shape == (2, sq, h, d) and out.dtype == DT[dt][1]
    _close(out, ref, dt)


def _decode_inputs(seed, b, h, kv, d, smax, dt):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    vc = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    return _pair(q, dt), _pair(kc, dt), _pair(vc, dt)


# 8 splits of 128: 1 and 100 leave seven whole splits masked, 300 five
@pytest.mark.parametrize("cache_len", [1, 100, 300, 1024])
def test_decode_plain_matches_pallas_interpret(pallas_load, cache_len):
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(2, 2, 4, 2, 64, 1024, "f32")
    ref = ref_decode(jq, jk, jv, jnp.int32(cache_len), impl="pallas")
    out = decode_attention(tq, tk, tv, cache_len)
    _close(out, ref, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,kv,d", [(4, 4, 64), (14, 2, 64), (8, 1, 128),
                                    (4, 4, 112)])
@pytest.mark.parametrize("smax,cache_len", [(100, 1), (100, 65), (256, 256),
                                            (300, 129)])
def test_decode_plain_matches_xla(dt, h, kv, d, smax, cache_len):
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(3, 2, h, kv, d, smax, dt)
    ref = ref_decode(jq, jk, jv, jnp.int32(cache_len), impl="xla")
    out = decode_attention(tq, tk, tv, cache_len)
    assert out.shape == (2, h, d) and out.dtype == DT[dt][1]
    _close(out, ref, dt)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros((1, 8, 4, 32)), torch.zeros((1, 8, 2, 32)),
                        torch.zeros((1, 8, 2, 32)))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 3, 64)))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=-1)
    qd, kc = torch.zeros((1, 4, 64)), torch.zeros((1, 16, 2, 64))
    for bad in (0, 17):
        with pytest.raises(ValueError, match="cache_len"):
            decode_attention(qd, kc, kc, bad)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(qd, kc.bfloat16(), kc.bfloat16(), 4)

