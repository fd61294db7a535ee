"""The numerics of the port's bf16 SSD scan kernel, on the CPU.

The CUDA kernel (``csrc/ssd_scan.cu``: ``ssd_mma_kernel``) runs only on the
card (``tests/test_torch_cuda.py``).  What it computes is held here against
the reference, from the same numpy inputs.  :func:`mma_numerics` repeats
its arithmetic in plain PyTorch: chunks of 64 with the ragged tail padded
by zeros (dt = x = B = C = 0); G = C B^T of the bf16 operands as given,
summed in float32; the decay exp(cum_t - cum_s) dt_s within a 16-position
block masked BEFORE the exp, and across blocks as two factors that never
exceed 1 (exp(cum_t - cum_e) and exp(cum_e - cum_s) dt_s, e the last
position of s's block); the float32 weights W split into a bf16 high
part and a bf16 residual, two products with x; the state S rounded once to
bf16 for its product with C; in the state update S <- exp(total) S +
(B u)^T x (u_s = exp(total - cum_s) dt_s) the float32 operand B u split
the same way; every sum in float32.  It is held against

* the reference's Pallas kernel ``ssd_scan_kernel_call`` in interpret mode
  (``impl="pallas"``; the fixture supplies ``pl.load`` and ``pl.store``,
  which the installed JAX no longer has, for the test's duration),
* the reference's XLA twin ``ssd_chunked`` at the reference model's chunk
  rule: a long sequence, a ragged one, G < H and an initial state,
* and the port's ``ssd_scan_plain``,

with y within 5e-2 (1 + |ref|) (bf16) and the final state within
1e-4 (1 + |ref|), the tolerances the card holds the kernel to.  Two tests
pin why the products are split: rounding the state update's operand once
to bf16 (u x or B u) moves the state past 1e-4 over a long sequence, and
the split keeps it well inside; rounding W once multiplies y's error
against the float32 scan several times at the model's dt.

Inputs decay mildly (dt in [0.01, 0.1]), as in ``tests/test_torch_ssm.py``,
so the state carried across chunks matters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.ssm_scan.ops import ssd_scan as ref_ssd_scan
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssm_scan import (effective_chunk, ssd_scan,
                                          ssd_scan_plain)
from repro_torch.kernels.ssm_scan.ops import expand_groups

KERNEL_CHUNK = 64  # csrc/ssd_scan.cu: L
Y_TOL, STATE_TOL = 5e-2, 1e-4


@pytest.fixture(scope="module")
def pallas_refs():
    def store(ref, idx, val):
        ref[idx] = val

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
        if not hasattr(pl, "store"):
            mp.setattr(pl, "store", store, raising=False)
        yield


def _bf16(t):
    return t.to(torch.bfloat16).float()


def mma_numerics(x, dt, a_log, b, c, d_skip, initial_state=None, *,
                 update="split", weights="split", out_dtype=None):
    """The bf16 kernel's arithmetic.  x, b, c bf16; dt, a_log, d_skip and
    the initial state float32.  ``update`` is the state update's operand:
    "split" (the kernel's: B u as bf16 hi + lo), or B u ("once_ub") or u x
    ("once_ux") rounded once to bf16; ``weights`` "split" (the kernel's) or
    "once" likewise for W.  Returns (y in ``out_dtype``, x's by default,
    final state float32)."""
    bs, s, h, p = x.shape
    n = b.shape[3]
    cl = KERNEL_CHUNK
    nc = -(-s // cl)
    pad = nc * cl - s

    def chunks(t, width):  # (B, S, H, width) -> (B, nc, cl, H, width)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(bs, nc, cl, h, width)

    xf = chunks(x, p)
    bf = chunks(expand_groups(b, h, 2), n)
    cf = chunks(expand_groups(c, h, 2), n)
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bs, nc, cl, h)
    a = -torch.exp(a_log.float())
    cum = torch.cumsum(dtf * a, dim=2)  # (B, nc, cl, H)
    total = cum[:, :, -1]
    mask = torch.ones((cl, cl), dtype=torch.bool).tril()
    blk = torch.arange(cl) // 16
    below = blk[:, None] > blk[None, :]  # (t, s): s in an earlier block
    ends = 16 * blk + 15  # the last position of each position's block
    state = (torch.zeros((bs, h, n, p)) if initial_state is None
             else initial_state.float().clone())
    ys = []
    for k in range(nc):
        ck, bk, xk = cf[:, k], bf[:, k], xf[:, k]  # (B, cl, H, .)
        cumk = cum[:, k]  # (B, cl, H)
        g = torch.einsum("bthn,bshn->bhts", ck, bk)
        ldiff = (cumk[:, :, None, :] - cumk[:, None, :, :]).permute(0, 3, 1, 2)
        dts = dtf[:, k].permute(0, 2, 1)[:, :, None, :]  # (B, H, 1, s)
        w = torch.where(mask, g * torch.exp(torch.where(mask, ldiff, 0.0))
                        * dts, 0.0)
        cumh = cumk.permute(0, 2, 1)  # (B, H, cl)
        alpha = torch.exp(torch.clamp(  # (B, H, t, s): cum_t - cum_e(s)
            cumh[..., :, None] - cumh[..., None, ends], max=0.0))
        beta = torch.exp(cumh[..., ends] - cumh) * dts[:, :, 0]  # (B, H, s)
        w = torch.where(below, g * alpha * beta[..., None, :], w)
        inter = torch.einsum("bthn,bhnp->bthp", ck, _bf16(state))
        w_hi = _bf16(w)
        w_parts = (w_hi, _bf16(w - w_hi)) if weights == "split" else (w_hi,)
        y = torch.exp(cumk)[..., None] * inter
        for part in w_parts:
            y = y + torch.einsum("bhts,bshp->bthp", part, xk)
        ys.append(y + d_skip.float()[None, None, :, None] * xk)
        u = torch.exp(total[:, k, None, :] - cumk) * dtf[:, k]  # (B, cl, H)
        if update == "once_ux":
            upd = torch.einsum("bshn,bshp->bhnp", bk, _bf16(u[..., None] * xk))
        else:
            v = u[..., None] * bk
            hi = _bf16(v)
            parts = (hi, _bf16(v - hi)) if update == "split" else (hi,)
            upd = sum(torch.einsum("bshn,bshp->bhnp", part, xk)
                      for part in parts)
        state = torch.exp(total[:, k])[..., None, None] * state + upd
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(out_dtype or x.dtype), state


def _inputs(seed, b, s, h, p, g, n, init=False):
    """Mild-decay inputs as float32 numpy arrays (``tests/test_torch_ssm.py``'s
    draw)."""
    rng = np.random.default_rng(seed)
    out = {
        "x": rng.standard_normal((b, s, h, p)),
        "dt": rng.uniform(0.01, 0.1, (b, s, h)),
        "a_log": 0.5 * rng.standard_normal(h),
        "b": 0.3 * rng.standard_normal((b, s, g, n)),
        "c": 0.3 * rng.standard_normal((b, s, g, n)),
        "d_skip": 1.0 + 0.2 * rng.standard_normal(h),
        "init": 0.5 * rng.standard_normal((b, h, n, p)) if init else None,
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in out.items()}


NAMES = ("x", "dt", "a_log", "b", "c", "d_skip")
LOW = {"x", "b", "c"}


def _torch_args(arrs):
    args = [torch.from_numpy(arrs[k]).to(torch.bfloat16 if k in LOW
                                          else torch.float32) for k in NAMES]
    init = None if arrs["init"] is None else torch.from_numpy(arrs["init"])
    return args, init


def _jax_args(arrs):
    args = [jnp.asarray(arrs[k], jnp.bfloat16 if k in LOW else jnp.float32)
            for k in NAMES]
    init = None if arrs["init"] is None else jnp.asarray(arrs["init"])
    return args, init


def _excess(out, ref, tol):
    """max |out - ref| / (tol (1 + |ref|)): at most 1 within tolerance."""
    out, ref = (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t, np.float32) for t in (out, ref))
    return float((np.abs(out - ref) / (tol * (1.0 + np.abs(ref)))).max())


def _assert_close(y, st, ry, rs):
    assert _excess(y, ry, Y_TOL) <= 1.0, _excess(y, ry, Y_TOL)
    assert _excess(st, rs, STATE_TOL) <= 1.0, _excess(st, rs, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n", [
    (1, 256, 2, 64, 1, 64),    # zamba2's P = N = 64, two reference chunks
    (2, 128, 4, 32, 2, 16),    # G < H
])
def test_mma_numerics_match_pallas_interpret(pallas_refs, b, s, h, p, g, n):
    arrs = _inputs(10, b, s, h, p, g, n)
    jx, _ = _jax_args(arrs)
    tx, _ = _torch_args(arrs)
    ry, rs = ref_ssd_scan(*jx, impl="pallas")
    y, st = mma_numerics(*tx)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, n, p)
    _assert_close(y, st, ry, rs)


@pytest.mark.parametrize("b,s,h,p,g,n,init", [
    (1, 1024, 2, 64, 1, 64, True),   # long, mild decay: 16 kernel chunks
    (1, 200, 4, 32, 2, 16, False),   # ragged: 3 chunks + 8, G < H
    (2, 37, 3, 16, 3, 32, True),     # shorter than a chunk, G = H
    (1, 130, 4, 128, 1, 128, True),  # the widest P and N
    (2, 1, 2, 48, 1, 80, True),      # one position; P, N padded in-kernel
])
def test_mma_numerics_match_xla_and_plain(b, s, h, p, g, n, init):
    arrs = _inputs(11, b, s, h, p, g, n, init)
    jx, jinit = _jax_args(arrs)
    tx, tinit = _torch_args(arrs)
    y, st = mma_numerics(*tx, tinit)
    ry, rs = ref_ssm.ssd_chunked(*jx, effective_chunk(s),
                                 initial_state=jinit)
    _assert_close(y, st, ry, rs)
    py, ps = ssd_scan_plain(*tx, tinit)
    _assert_close(y, st, py, ps)


def test_split_state_update_is_needed():
    """Rounding the state update's float32 operand once to bf16 (u x, the
    usual practice, or B u) moves the final state past 1e-4 (1 + |plain|)
    over 1,024 positions; the hi + lo split keeps it at least ten times
    inside.  y meets its tolerance every way."""
    arrs = _inputs(0, 1, 1024, 4, 64, 1, 64)
    tx, _ = _torch_args(arrs)
    py, ps = ssd_scan_plain(*tx)
    for update in ("once_ux", "once_ub", "split"):
        y, st = mma_numerics(*tx, update=update)
        if update == "split":
            assert _excess(st, ps, STATE_TOL) < 0.1
        else:
            assert _excess(st, ps, STATE_TOL) > 1.0, update
        assert _excess(y, py, Y_TOL) <= 1.0


def test_split_weights_track_the_float32_scan():
    """At the model's dt (softplus of a unit normal), W rounded once to bf16
    puts y several times further from the float32 scan than the split
    does (before y's own rounding); the split leaves the bf16 copy of the
    state as the larger part of what remains."""
    arrs = _inputs(3, 2, 256, 8, 32, 1, 16, init=True)
    arrs["dt"] = np.log1p(np.exp(
        np.random.default_rng(3).standard_normal((2, 256, 8)))).astype(
            np.float32)
    tx, tinit = _torch_args(arrs)
    f32 = [t.float() for t in tx]
    py, _ = ssd_scan_plain(*f32, tinit)

    def rel_rms(weights):
        y, _ = mma_numerics(*tx, tinit, weights=weights,
                            out_dtype=torch.float32)
        return float((y - py).pow(2).mean().sqrt() / py.pow(2).mean().sqrt())

    once, split = rel_rms("once"), rel_rms("split")
    assert once > 3 * split and split < 5e-4, (once, split)


def test_mask_before_exp_keeps_strong_decay_finite():
    """dt A of -30 a step overflows exp(cum_t - cum_s) above the diagonal;
    the masked weights stay finite and meet the sequential oracle."""
    arrs = _inputs(4, 1, 70, 2, 16, 1, 16)
    arrs["dt"][:] = 30.0
    arrs["a_log"][:] = 0.0
    tx, _ = _torch_args(arrs)
    y, st = mma_numerics(*tx)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    jx, _ = _jax_args(arrs)
    ry, rs = ref_ssm.ssd_sequential(*jx)
    _assert_close(y, st, ry, rs)


def test_model_hands_the_scan_views():
    """The Mamba-2 block passes x, b and c to the scan as slices of its one
    activation, with no copy; the scan reads them as it reads copies."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import ssm as port_ssm

    cfg = reduced_config(get_config("zamba2-7b"))
    params = port_ssm.init_mamba2_block(torch.Generator().manual_seed(0),
                                        cfg, "cpu")
    x = torch.randn((2, 20, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    seen = []

    def probe(xs, dt, a_log, b, c, *args, **kw):
        seen.append((xs, b, c))
        return ssd_scan(xs, dt, a_log, b, c, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ssm, "ssd_scan", probe)
        port_ssm.apply_mamba2_block(cfg, params, x)
    (xs, b, c), = seen
    storage = xs.untyped_storage().data_ptr()
    assert not xs.is_contiguous() and not b.is_contiguous()
    assert all(t.untyped_storage().data_ptr() == storage for t in (b, c))
    args, _ = _torch_args(_inputs(12, 2, 20, xs.shape[2], xs.shape[3], 1,
                                  b.shape[3]))
    args[0], args[3], args[4] = xs, b, c
    y, st = ssd_scan(*args)
    yc, sc = ssd_scan(xs.contiguous(), *args[1:3], b.contiguous(),
                      c.contiguous(), args[5])
    assert torch.equal(y, yc) and torch.equal(st, sc)


def test_scan_refuses_rows_it_cannot_copy():
    """A token stride that is not a multiple of 16 bytes, or unpacked
    (H, P) dims, raise; a 16-byte token stride is taken."""
    args, _ = _torch_args(_inputs(13, 1, 8, 2, 16, 1, 16))
    wide = torch.zeros((1, 8, 2 * 16 + 4), dtype=torch.bfloat16)
    args[0] = wide[..., :32].reshape(1, 8, 2, 16)  # 72-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        ssd_scan(*args)
    wide = torch.zeros((1, 8, 2 * 16 + 8), dtype=torch.bfloat16)
    args[0] = wide[..., :32].reshape(1, 8, 2, 16)  # 80-byte rows
    y, _ = ssd_scan(*args)
    assert y.shape == (1, 8, 2, 16)
    args[0] = torch.zeros((1, 8, 16, 2), dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(*args)
