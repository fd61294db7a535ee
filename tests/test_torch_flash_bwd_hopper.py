"""The numerics of the port's flash attention backward kernel, on the CPU.

``csrc/flash_attention_bwd.cu`` runs only on the card
(``tests/test_torch_cuda.py``).  What it computes is held here, from the
same numpy inputs, against the reference's autodiff and the port's plain
backward:

* :func:`fa2_numerics` repeats the kernel's arithmetic in plain PyTorch:
  the forward's LSE (an online softmax over 64-key tiles, float32 (m, l)),
  Delta = rowsum(dO o out) in float32 from the output carried as its
  value in the operand dtype plus that rounding's residual (the
  forward's ``out_lo``), P = exp(S - LSE) from float32 products of the
  operands (the scale on the float32 scores), dP in float32,
  dS = P (dP - Delta), and P and dS rounded to the operand dtype before
  their products; dQ summed over
  the 64-key tiles its rows see, dK and dV over each KV head's group of
  query heads and the query tiles in the kernel's fixed order, all in
  float32, the scale applied to the float32 sums of dQ and dK.  In
  bfloat16 the group is cut as the dkdv launch cuts it
  (``dkdv_splits``, :func:`split_heads`): each split's float32 partial
  over its own heads, then the partials summed in split order.
* The split plan at the five training shapes of the path: the dkdv grid
  reaches a wave of the card or needs no split, each split whole heads.
* ``flash_attention_grad_work``, the kernel table's bound, pinned at those
  shapes to the values it has had since the backward kernel came in.
* It is held to ``jax.vjp`` of the reference's ``gqa_attend`` (causal,
  with and without ``q_offset``, and not) and ``chunked_gqa_attend``
  (non-causal, sq != skv, several query chunks), and to the port's
  ``flash_attention_grad``, at head dims 64, 112 and 128, groups 1, 7 and
  8 and ragged lengths, within 1e-5 * (1 + |ref|) in float32 and
  5e-2 * (1 + |ref|) in bfloat16 (``tests/test_torch_ssd_grad.py``'s
  tolerances).
* The device rule of ``FlashAttentionFn``'s backward: a CPU tensor runs
  the plain backward (and no kernel is counted), a meta tensor notes the
  backward kernel's work (``flash_attention_grad_work``) and allocates
  only the gradients (inside ``_build.plain_on_meta`` it runs the plain
  backward's ops instead), and any other device raises.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import gqa_attend
from repro.models.transformer import chunked_gqa_attend
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as FA

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 5e-2}
TILE = 64
NEG_INF = -1e30


def _visible(sq, skv, causal, q_offset):
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool)
    return (torch.arange(sq)[:, None] + q_offset
            >= torch.arange(skv)[None, :])


def split_heads(group, splits):
    """The query heads of a KV head's group each split of the dkdv launch
    takes, [lo, hi) in the group: whole heads, cut as
    ``csrc/flash_attention_bwd.cu`` cuts them."""
    return [(i * group // splits, (i + 1) * group // splits)
            for i in range(splits)]


def forward_numerics(q, k, v, *, causal, q_offset):
    """The forward kernel's output (float32, before its rounding to q's
    dtype) and LSE (float32 (b, H, sq)): an online softmax over 64-key
    tiles, P rounded before P V."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kf = FA.repeat_kv(k, h).float()
    vf = FA.repeat_kv(v, h).float()
    vis = _visible(sq, skv, causal, q_offset)
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, TILE):
        s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                         kf[:, k0:k0 + TILE]) * d ** -0.5
        s = torch.where(vis[:, k0:k0 + TILE], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p.to(q.dtype).float(), vf[:, k0:k0 + TILE])
        m = m_new
    return (acc / l[..., None]).transpose(1, 2), m + torch.log(l)


def fa2_numerics(q, k, v, do, *, causal, q_offset, residual=True):
    """The backward kernels' arithmetic: (dq, dk, dv) in q's dtype.
    ``residual=False`` forms Delta from the rounded output alone."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    dtype = q.dtype
    scale = d ** -0.5
    out, lse = forward_numerics(q, k, v, causal=causal, q_offset=q_offset)
    hi = out.to(dtype).float()
    # the output in the operand dtype, plus the residual the forward writes
    out = hi + (out - hi).to(dtype).float() if residual else hi
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf = FA.repeat_kv(k, h).float().transpose(1, 2)  # (b, H, skv, d)
    vf = FA.repeat_kv(v, h).float().transpose(1, 2)
    delta = (dof * out.float().transpose(1, 2)).sum(-1)  # (b, H, sq)
    vis = _visible(sq, skv, causal, q_offset)

    def p_ds(q0, k0):  # P (rounded) and dS (rounded) of one pair of tiles
        qs, ks = slice(q0, q0 + TILE), slice(k0, k0 + TILE)
        s = torch.einsum("bhqd,bhsd->bhqs", qf[:, :, qs], kf[:, :, ks])
        p = torch.where(vis[qs, ks], torch.exp(s * scale
                                               - lse[:, :, qs, None]), 0.0)
        dp = torch.einsum("bhqd,bhsd->bhqs", dof[:, :, qs], vf[:, :, ks])
        ds = p * (dp - delta[:, :, qs, None])
        return p.to(dtype).float(), ds.to(dtype).float()

    # dq kernel: each 64-query tile walks its key tiles in order
    dq = torch.zeros((b, h, sq, d))
    for q0 in range(0, sq, TILE):
        for k0 in range(0, skv, TILE):
            _, ds = p_ds(q0, k0)
            dq[:, :, q0:q0 + TILE] += torch.einsum(
                "bhqs,bhsd->bhqd", ds, kf[:, :, k0:k0 + TILE])
    # dkdv kernel: each 64-key tile walks its split's heads, then the query
    # tiles, in that order, into one float32 sum a split; the splits'
    # partials are then summed in split order (one split in float32)
    splits = (FA.dkdv_splits(b, skv, kvh, group) if dtype == torch.bfloat16
              else 1)
    dk = torch.zeros((b, kvh, skv, d))
    dv = torch.zeros((b, kvh, skv, d))
    for k0 in range(0, skv, TILE):
        ks = slice(k0, k0 + TILE)
        for lo, hi in split_heads(group, splits):
            pk = torch.zeros((b, kvh, dk[:, :, ks].shape[2], d))
            pv = torch.zeros_like(pk)
            for j in range(lo, hi):
                heads = torch.arange(kvh) * group + j
                for q0 in range(0, sq, TILE):
                    p, ds = p_ds(q0, k0)
                    qs = slice(q0, q0 + TILE)
                    pv += torch.einsum(
                        "bhqs,bhqd->bhsd", p[:, heads], dof[:, heads, qs])
                    pk += torch.einsum(
                        "bhqs,bhqd->bhsd", ds[:, heads], qf[:, heads, qs])
            dk[:, :, ks] += pk
            dv[:, :, ks] += pv
    return ((dq * scale).transpose(1, 2).to(dtype),
            (dk * scale).transpose(1, 2).to(dtype),
            dv.transpose(1, 2).to(dtype))


def _arrays(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(b, sq, h, d), f(b, skv, kv, d), f(b, skv, kv, d),
            f(b, sq, h, d)]


def _excess(got, want, tol):
    """The largest |got - want| / (1 + |want|), over tol."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item() / tol


def _jax_vjp(fn, arrays, jdt):
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    return [torch.from_numpy(np.array(w, np.float32)) for w in vjp(jdo)]


# (b, sq, skv, H, KV, d, causal, q_offset): groups 1, 7 and 8; ragged
# lengths (not multiples of 64); q_offset: queries behind a cached prefix
CASES = [(2, 70, 70, 4, 4, 64, True, 0), (1, 100, 100, 7, 1, 112, True, 0),
         (1, 50, 114, 8, 1, 128, True, 64), (2, 40, 90, 4, 2, 64, False, 0),
         (1, 65, 129, 8, 1, 64, True, 64)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,off", CASES)
def test_fa2_numerics_match_the_references_vjp(dt, b, sq, skv, h, kv, d,
                                                causal, off):
    jdt, tdt = DT[dt]
    arrays = _arrays(sq * skv + h, b, sq, skv, h, kv, d)
    want = _jax_vjp(lambda q, k, v: gqa_attend(q, k, v, causal, 0.0, off),
                    arrays, jdt)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = fa2_numerics(q, k, v, do, causal=causal, q_offset=off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        assert _excess(g, w, TOL[dt]) <= 1, (name, _excess(g, w, TOL[dt]))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", [(192, 150), (192, 64)])
def test_fa2_numerics_match_the_chunked_twin(dt, sq, skv):
    """Non-causal, sq != skv, over three query chunks of the twin's scan
    (whisper's cross attention is its training use)."""
    jdt, tdt = DT[dt]
    arrays = _arrays(sq + skv, 1, sq, skv, 4, 4, 64)
    want = _jax_vjp(lambda q, k, v: chunked_gqa_attend(q, k, v, False,
                                                       q_chunk=64),
                    arrays, jdt)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = fa2_numerics(q, k, v, do, causal=False, q_offset=0)
    for g, w in zip(got, want):
        assert _excess(g, w, TOL[dt]) <= 1, _excess(g, w, TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,off", CASES[:3])
def test_fa2_numerics_match_the_plain_backward(dt, b, sq, skv, h, kv, d,
                                               causal, off):
    tdt = DT[dt][1]
    arrays = _arrays(sq + 3 * skv, b, sq, skv, h, kv, d)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = fa2_numerics(q, k, v, do, causal=causal, q_offset=off)
    want = FA.flash_attention_grad(q, k, v, do, causal=causal, q_offset=off)
    for g, w in zip(got, want):
        assert _excess(g, w, TOL[dt]) <= 1, _excess(g, w, TOL[dt])


def test_forward_numerics_lse_is_the_rows_logsumexp():
    arrays = _arrays(7, 2, 90, 150, 6, 2, 112)
    q, k, v, _ = (torch.from_numpy(a) for a in arrays)
    out, lse = forward_numerics(q, k, v, causal=True, q_offset=64)
    s = torch.einsum("bqhd,bshd->bhqs", q, FA.repeat_kv(k, 6)) * 112 ** -0.5
    want = torch.where(_visible(90, 150, True, 64), s,
                       -torch.inf).logsumexp(-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(out, FA.flash_attention_plain(
        q, k, v, causal=True, q_offset=64), atol=1e-5, rtol=1e-5)


def test_delta_needs_the_outputs_residual():
    """At the ``train`` path's shape cut to one row, Delta from the bf16
    output alone puts dq further from the float32 plain backward (the
    largest |err| / (min(1, RMS) + |ref|), ``chip_smoke.py``'s reading)
    than Delta from the output with the forward's residual, which keeps
    it under that hold's 5e-2."""
    arrays = _arrays(0, 1, 512, 512, 14, 2, 64)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention_plain(*leaves, causal=True).backward(do.float())
    ref = leaves[0].grad
    floor = min(1.0, ref.square().mean().sqrt().item())

    def reading(residual):
        dq = fa2_numerics(q, k, v, do, causal=True, q_offset=0,
                          residual=residual)[0]
        return ((dq.float() - ref).abs() / (floor + ref.abs())).max().item()

    with_residual, rounded = reading(True), reading(False)
    assert with_residual <= 5e-2 and with_residual < rounded, (
        with_residual, rounded)


# -- the device rule --------------------------------------------------------

def _fn_grads(q, k, v, do, causal=True):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.FlashAttentionFn.apply(*leaves, causal, 0)
    return torch.autograd.grad(out, leaves, do)


def test_cpu_backward_is_the_plain_backward():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(3, 2, 40, 40, 4, 2,
                                                         64))
    reset_launch_counts()
    got = _fn_grads(q, k, v, do)
    want = FA.flash_attention_grad(q, k, v, do, causal=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("causal", [True, False])
def test_meta_backward_notes_the_kernels_work(causal):
    b, sq, skv, h, kv, d = 2, 96, 96, 8, 2, 64
    q = torch.empty((b, sq, h, d), device="meta", dtype=torch.bfloat16)
    k = torch.empty((b, skv, kv, d), device="meta", dtype=torch.bfloat16)
    with _build.record_meta_work() as work:
        grads = _fn_grads(q, k, k, torch.empty_like(q), causal)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert all(g.device.type == "meta" for g in grads)
    noted = {name: (f, n) for name, f, n in work}
    assert noted["flash_attention_bwd"] == FA.flash_attention_grad_work(
        b, sq, skv, h, kv, d, causal, 0, 2)
    flops = noted["flash_attention_bwd"][0]
    assert flops == pytest.approx(
        2.5 * noted["flash_attention"][0], rel=1e-12)
    with _build.plain_on_meta(), _build.record_meta_work() as plain:
        _fn_grads(q, k, k, torch.empty_like(q), causal)
    assert plain == []


# (b, skv, KV, group) of the dkdv launch at the path's training shapes:
# train (q 8 x 512 x 14 x 64 over 2 KV heads), internvl2's layer (2 x 512,
# 64 over 8, d 128), whisper's encoder and cross attention (16 heads over
# 16, 1,500 keys), train_hybrid's shared attention (3 x 512, 32 over 32)
SPLIT_SHAPES = {"train": (8, 512, 2, 7), "internvl2": (2, 512, 8, 8),
                "whisper_encoder": (4, 1500, 16, 1),
                "whisper_cross": (4, 1500, 16, 1),
                "train_hybrid": (3, 512, 32, 1)}
SPLITS = {"train": 3, "internvl2": 3, "whisper_encoder": 1,
          "whisper_cross": 1, "train_hybrid": 1}


@pytest.mark.parametrize("name", sorted(SPLIT_SHAPES))
def test_dkdv_split_plan_fills_a_wave_with_whole_heads(name):
    """Under one wave of blocks (a (64-key tile, KV head, row) each) the
    group is split until the grid reaches one, at most one split a head;
    at or above it there is no split.  The splits cover the group in
    order, each a whole number of query heads (at least one)."""
    b, skv, kv, group = SPLIT_SHAPES[name]
    blocks = b * -(-skv // TILE) * kv
    splits = FA.dkdv_splits(b, skv, kv, group)
    assert splits == SPLITS[name]
    assert 1 <= splits <= group
    if blocks >= FA.SMS:
        assert splits == 1
    else:
        assert blocks * splits >= FA.SMS
    heads = split_heads(group, splits)
    assert len(heads) == splits and heads[0][0] == 0
    assert heads[-1][1] == group
    assert all(lo < hi for lo, hi in heads)
    assert all(a[1] == b_[0] for a, b_ in zip(heads, heads[1:]))


# flash_attention_grad_work at the kernel table's row 4 shapes (train,
# whisper's encoder and cross attention, internvl2's layer) and
# train_hybrid's shared attention: (operations, bytes), the values the
# bound has had since the backward kernel came in
GRAD_WORK = [((8, 512, 512, 14, 2, 64, True, 0, 2),
              (9413591040.0, 33783808.0)),
             ((4, 1500, 1500, 16, 16, 64, False, 0, 2),
              (92160000000.0, 98688000.0)),
             ((4, 187, 1500, 16, 16, 64, False, 0, 2),
              (11489280000.0, 55327488.0)),
             ((2, 512, 512, 64, 8, 128, True, 0, 2),
              (21516779520.0, 75759616.0)),
             ((3, 512, 512, 32, 32, 112, True, 0, 2),
              (14120386560.0, 88276992.0))]


@pytest.mark.parametrize("args,want", GRAD_WORK)
def test_grad_work_is_pinned_at_the_path_shapes(args, want):
    """The bound does not move with the kernel's design."""
    assert FA.flash_attention_grad_work(*args) == want


def test_grad_work_counts_the_minimal_backward():
    """10 d a visible pair and head; causal sees s (s + 1) / 2 pairs;
    bytes: q, out, dO, k, v read, the float32 LSE, dq, dk, dv written."""
    flops, nbytes = FA.flash_attention_grad_work(2, 64, 64, 4, 2, 16, True,
                                                 0, 2)
    assert flops == 10 * 2 * 4 * 16 * (64 * 65 // 2)
    q_el, kv_el = 2 * 64 * 4 * 16, 2 * 64 * 2 * 16
    assert nbytes == 2 * (4 * q_el + 4 * kv_el) + 4 * 2 * 4 * 64


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_raise():
    q = torch.zeros((1, 8, 2, 64)).as_subclass(_Elsewhere)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        FA._attend_grad(q, q, q, q, q, lse, q, True, 0)
