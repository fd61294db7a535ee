"""The numerics of the port's Hopper attention kernels, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).
What they compute is held here against the reference, from the same numpy
inputs:

* ``flash_attention``'s bf16 kernel: bf16 operands, float32 scores with
  the scale applied after the product, an online softmax over key tiles,
  and P rounded to the operand dtype per tile before P V.
  :func:`wgmma_numerics` repeats that in plain PyTorch, at the kernel's
  64-key tiles and at the reference's 128, and is held against the
  reference's ``flash_attention(impl="xla")`` and its Pallas kernel in
  interpret mode (``impl="pallas"``; the fixture below supplies
  ``pl.load``, which newer JAX releases dropped, for the test's duration).
* ``decode_attention``'s split plan (:func:`split_plan`): the splits cover
  [0, cache_len) exactly, none is empty, at most 8 (one cluster).
* its in-kernel merge: plain float32 partials (m, l, acc) over the plan,
  merged exactly, equal :func:`decode_attention_plain` and the reference's
  ``combine_splits`` over the same partials.

Tolerances are ``tests/test_kernels.py``'s: 5e-5 in float32 and 5e-2 in
bfloat16.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels import flash_attention as ref_flash
from repro.kernels.decode_attention.kernel import combine_splits
from repro_torch.kernels.decode_attention.ops import (MAX_SPLITS,
                                                      decode_attention_plain,
                                                      split_plan)
from repro_torch.kernels.flash_attention.ops import repeat_kv

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}
NEG_INF = -1e30


@pytest.fixture(scope="module")
def pallas_load():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
        yield


def wgmma_numerics(q, k, v, *, causal, q_offset, block_k):
    """The bf16 flash kernel's arithmetic: float32 products of the operands
    as given, the scale on the float32 scores, an online softmax over
    ``block_k``-key tiles with float32 (m, l, acc), and the unnormalised
    weights of each tile rounded to the operand dtype before P V."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kf, vf = repeat_kv(k, h).float(), repeat_kv(v, h).float()
    qf = q.float()
    qpos = torch.arange(sq)[:, None] + q_offset
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bshd->bhqs", qf, kt) * d ** -0.5
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p.to(q.dtype).float(), vt)
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


def _qkv(seed, b, sq, skv, h, kv, d, dt):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]
    jdt, tdt = DT[dt]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _close(port, ref, dt):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 112])
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("b,sq,skv,h,kv,causal", [
    (2, 100, 300, 4, 2, True),    # ragged, sq < skv (q_offset = skv - sq)
    (1, 129, 129, 7, 1, True),    # GQA group 7, one row past a tile
    (2, 65, 200, 4, 4, False),
])
def test_wgmma_numerics_match_xla(dt, d, block_k, b, sq, skv, h, kv, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(d + sq, b, sq, skv, h, kv, d, dt)
    off = skv - sq if causal else 0
    ref = ref_flash(jq, jk, jv, causal=causal, q_offset=off, impl="xla")
    out = wgmma_numerics(tq, tk, tv, causal=causal, q_offset=off,
                         block_k=block_k)
    assert out.shape == (b, sq, h, d) and out.dtype == DT[dt][1]
    _close(out, ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 112])
@pytest.mark.parametrize("q_offset", [0, 32])
def test_wgmma_numerics_match_pallas_interpret(pallas_load, dt, d, q_offset):
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 128, 128 + q_offset, 4, 2, d, dt)
    ref = ref_flash(jq, jk, jv, causal=True, q_offset=q_offset, impl="pallas")
    for block_k in (64, 128):
        out = wgmma_numerics(tq, tk, tv, causal=True, q_offset=q_offset,
                             block_k=block_k)
        _close(out, ref, dt)


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("b,kv", [(1, 1), (2, 2), (8, 2), (1, 8), (8, 32)])
def test_split_plan_covers_the_cache(b, kv, d):
    for cache_len in range(1, 2 * 2048 + 2):
        n, length = split_plan(b, kv, d, cache_len)
        assert 1 <= n <= MAX_SPLITS
        # the splits [i L, min((i + 1) L, cache_len)) tile [0, cache_len)
        # and the last one starts before cache_len
        assert (n - 1) * length < cache_len <= n * length
        assert length % 16 == 0
        # one wave of 132 SMs, or the cluster's 8 splits, once the cache is
        # long enough
        if cache_len >= 8 * length:
            assert b * kv * n >= min(132, MAX_SPLITS * b * kv)


def test_split_plan_at_the_serving_shapes():
    assert split_plan(8, 2, 64, 1055) == (5, 224)     # qwen2-0.5b, 80 blocks
    assert split_plan(8, 32, 112, 1039) == (1, 1040)  # zamba2-7b, 256 blocks
    with pytest.raises(ValueError):
        split_plan(8, 2, 64, 0)


def _plain_partials(q, kc, vc, cache_len, n_splits, split_len):
    """float32 (m, l, acc) of each split, as the kernel's blocks keep them:
    m, l (b, H, n) and acc (b, H, n, d)."""
    h, d = q.shape[1], q.shape[2]
    kf, vf = repeat_kv(kc, h).float(), repeat_kv(vc, h).float()
    qs = q.float() * d ** -0.5
    ms, ls, accs = [], [], []
    for i in range(n_splits):
        lo, hi = i * split_len, min((i + 1) * split_len, cache_len)
        s = torch.einsum("bhd,bshd->bhs", qs, kf[:, lo:hi])
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vf[:, lo:hi]))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


@pytest.mark.parametrize("b,h,kv,d,smax,cache_len", [
    (8, 14, 2, 64, 2048, 1055),   # qwen2-0.5b's last decode step
    (8, 14, 2, 64, 2048, 1120),   # on a split boundary (5 x 224)
    (2, 4, 2, 64, 1024, 1),
    (2, 8, 1, 128, 300, 129),
    (1, 48, 1, 128, 100, 65),
    (2, 32, 32, 112, 2048, 1039),
    (1, 8, 4, 112, 400, 336),     # 3 x 112
])
def test_exact_merge_of_plain_partials(b, h, kv, d, smax, cache_len):
    rng = np.random.default_rng(cache_len + d)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, h, d), (b, smax, kv, d), (b, smax, kv, d)))
    n, length = split_plan(b, kv, d, cache_len)
    m, l, acc = _plain_partials(q, kc, vc, cache_len, n, length)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    merged = (acc * w[..., None]).sum(-2) / (l * w).sum(-1)[..., None]
    ref = decode_attention_plain(q, kc, vc, cache_len)
    torch.testing.assert_close(merged, ref, atol=5e-5, rtol=5e-5)
    jax_merged = combine_splits(*(jnp.asarray(t.numpy()) for t in (m, l, acc)))
    _close(merged, jax_merged, "f32")
