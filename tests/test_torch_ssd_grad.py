"""The SSD scan's trainable form, ``SsdScanFn``, on the CPU.

``SsdScanFn`` runs ``ssd_scan``'s forward (here the plain version) and, in
its backward, the gradient of the reference's chunked numerics at the
reference model's chunk rule (``ssd_scan_grad``: autograd through a
recompute of ``ssd_scan_plain``).  From the same numpy inputs it is held

* to autograd through ``ssd_scan_plain`` itself, bit for bit (on the CPU
  the forward is that function and the backward differentiates it again);
* to ``jax.vjp`` of the reference's ``ssd_chunked`` at
  ``effective_chunk(S, chunk)``, jitted as its training step runs it,
  within 1e-5 * (1 + |ref|) in float32 (measured 3e-6: summation order)
  and 5e-2 * (1 + |ref|) in bfloat16 (measured 1.2e-2, on db and dc: the
  gradient of the group-major expansion of B and C is a sum over each
  group's heads, rounded to bfloat16 once here and at another point by
  XLA);

over float32 and bfloat16, 1 and 2 B/C groups, a chunk that divides S and
one that does not (the model's rule then takes one chunk of S), with and
without an initial state, and with cotangents on y alone, on the final
state alone and on both.  x, b and c given as token-strided views of one activation,
as the Mamba-2 block gives them, reach the forward as those views (no
copy) and their gradients land in the activation's.  Inputs decay mildly
(dt in [0.01, 0.1]), so the state carried across chunks matters.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssm_scan import (SsdScanFn, effective_chunk,
                                          ssd_scan_grad, ssd_scan_plain)
from repro_torch.kernels.ssm_scan import ops as SS

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (b, s, h, p, g, n, chunk, initial state): chunk 16 divides 32 and 40;
# 21 % 16 != 0 (one chunk of 21); chunk 128 over 64 positions is one chunk
CASES = [(2, 32, 4, 16, 1, 16, 16, False), (2, 40, 4, 16, 2, 16, 16, True),
         (1, 21, 6, 32, 2, 16, 16, True), (2, 64, 4, 32, 1, 32, 128, False)]


def _arrays(seed, b, s, h, p, g, n, init):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"x": f(b, s, h, p),
            "dt": (0.01 + 0.09 * rng.random((b, s, h))).astype(np.float32),
            "a_log": 0.5 * f(h), "b": 0.3 * f(b, s, g, n),
            "c": 0.3 * f(b, s, g, n), "d_skip": 1 + 0.2 * f(h),
            "init": 0.5 * f(b, h, n, p) if init else None,
            "dy": f(b, s, h, p), "dstate": f(b, h, n, p)}


def _leaves(a, dtype):
    """x, dt, a_log, b, c, d_skip, initial_state as leaves that require
    grad (x, b, c in ``dtype``; the rest float32)."""
    out = []
    for name in ("x", "dt", "a_log", "b", "c", "d_skip", "init"):
        if a[name] is None:
            out.append(None)
            continue
        t = torch.from_numpy(a[name].copy())
        if name in ("x", "b", "c"):
            t = t.to(dtype)
        out.append(t.requires_grad_(True))
    return out


def _cotangents(a, dtype, with_state):
    dy = torch.from_numpy(a["dy"]).to(dtype)
    return [dy, torch.from_numpy(a["dstate"])] if with_state else [dy]


def _grads(fn, a, dtype, chunk, with_state):
    leaves = _leaves(a, dtype)
    y, st = fn(*leaves, chunk)
    outs = [y, st] if with_state else [y]
    torch.autograd.backward(outs, _cotangents(a, dtype, with_state))
    return (y.detach(), st.detach()), [None if t is None else t.grad
                                       for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_fn_equals_autograd_of_the_plain_scan(dtype, case, with_state):
    b, s, h, p, g, n, chunk, init = case
    a = _arrays(s * h + p, b, s, h, p, g, n, init)
    (y, st), got = _grads(SsdScanFn.apply, a, dtype, chunk, with_state)
    (yw, stw), want = _grads(
        lambda *args: ssd_scan_plain(*args[:-1], chunk=args[-1]),
        a, dtype, chunk, with_state)
    assert torch.equal(y, yw) and torch.equal(st, stw)
    for g_, w, leaf in zip(got, want, _leaves(a, dtype)):
        if leaf is None:
            assert g_ is None and w is None
            continue
        assert g_.dtype == leaf.dtype and g_.shape == leaf.shape
        assert torch.equal(g_, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_ssd_fn_matches_the_references_vjp(dtype, case):
    b, s, h, p, g, n, chunk, init = case
    a = _arrays(s + h, b, s, h, p, g, n, init)
    cl = effective_chunk(s, chunk)
    jd = JDT[dtype]
    prim = [jnp.asarray(a["x"], jd), jnp.asarray(a["dt"]),
            jnp.asarray(a["a_log"]), jnp.asarray(a["b"], jd),
            jnp.asarray(a["c"], jd), jnp.asarray(a["d_skip"])]
    if init:
        prim.append(jnp.asarray(a["init"]))

    def ref(*args):
        return ssd_chunked(*args[:6], cl,
                           initial_state=args[6] if init else None)

    @jax.jit
    def ref_vjp(prim, dy, dstate):
        return jax.vjp(ref, *prim)[1]((dy, dstate))

    want = ref_vjp(prim, jnp.asarray(a["dy"], jd), jnp.asarray(a["dstate"]))
    _, got = _grads(SsdScanFn.apply, a, dtype, chunk, True)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        err = ((g_.float() - w).abs() / (1 + w.abs())).max().item()
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_fn_on_views_of_one_activation(dtype):
    """x, b and c as the Mamba-2 block hands them over: token-strided
    views of one (b, s, H P + 2 G N) activation.  The forward receives the
    views themselves, and their gradients land in the activation's, equal
    to the gradients through contiguous copies."""
    bs, s, h, p, g, n = 2, 40, 4, 16, 2, 16
    a = _arrays(5, bs, s, h, p, g, n, False)
    act = np.concatenate([a["x"].reshape(bs, s, -1), a["b"].reshape(bs, s, -1),
                          a["c"].reshape(bs, s, -1)], axis=-1)

    def views(t):
        xs, b, c = t.split([h * p, g * n, g * n], dim=-1)
        return (xs.reshape(bs, s, h, p), b.reshape(bs, s, g, n),
                c.reshape(bs, s, g, n))

    rest = [torch.from_numpy(a[k]) for k in ("dt", "a_log", "d_skip")]
    dy = torch.from_numpy(a["dy"]).to(dtype)
    seen = []
    orig = SS.ssd_scan_plain

    def probe(x, dt, a_log, b, c, *args, **kw):
        seen.append((x.data_ptr(), x.stride(), b.stride()))
        return orig(x, dt, a_log, b, c, *args, **kw)

    grads = []
    for as_views in (True, False):
        t = torch.from_numpy(act).to(dtype).requires_grad_(True)
        xs, b, c = views(t)
        if not as_views:
            xs, b, c = xs.contiguous(), b.contiguous(), c.contiguous()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SS, "ssd_scan_plain", probe)
            y, _ = SsdScanFn.apply(xs, rest[0], rest[1], b, c, rest[2], None,
                                   16)
        y.backward(dy)
        grads.append(t.grad)
        if as_views:
            ptr, xstride, bstride = seen[0]
            assert ptr == t.data_ptr()
            assert xstride == (s * act.shape[-1], act.shape[-1], p, 1)
            assert bstride == (s * act.shape[-1], act.shape[-1], n, 1)
    assert grads[0].shape == act.shape and grads[0].dtype == dtype
    assert torch.equal(grads[0], grads[1])


def test_ssd_grad_skips_what_needs_no_gradient():
    a = _arrays(3, 1, 16, 2, 16, 1, 16, True)
    leaves = [t.detach() for t in _leaves(a, torch.float32)]
    dy = torch.from_numpy(a["dy"])
    needs = (True, False, False, True, False, False, False)
    out = ssd_scan_grad(*leaves, dy, None, 16, needs)
    assert [o is not None for o in out] == list(needs)
    assert out[0].shape == leaves[0].shape and out[3].shape == leaves[3].shape
    assert ssd_scan_grad(*leaves, dy, None, 16, (False,) * 7) == (None,) * 7


def test_ssd_fn_with_only_the_final_state_used():
    """A cotangent on the final state alone (y unused) gives the plain
    version's gradients through the state (zeros where the state does not
    depend on the input: d_skip)."""
    a = _arrays(9, 2, 40, 4, 16, 2, 16, True)
    leaves = _leaves(a, torch.float32)
    _, st = SsdScanFn.apply(*leaves, 16)
    st.backward(torch.from_numpy(a["dstate"]))
    want = _leaves(a, torch.float32)
    _, sw = ssd_scan_plain(*want, chunk=16)
    sw.backward(torch.from_numpy(a["dstate"]))
    for g_, w in zip(leaves, want):
        w = torch.zeros_like(g_) if w.grad is None else w.grad
        assert torch.equal(g_.grad, w)
