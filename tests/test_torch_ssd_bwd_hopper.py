"""The numerics of the port's SSD scan backward kernel, on the CPU.

``csrc/ssd_scan_bwd.cu`` runs only on the card (``tests/test_torch_cuda.py``).
What it computes is held here, from the same numpy inputs, against the
reference's autodiff and the port's plain backward:

* :func:`reverse_scan_numerics` repeats the kernel's algorithm in plain
  PyTorch: the forward's float32 state before each 64-position chunk (its
  state update's operand B u split into bf16 hi + lo, as
  ``ssd_mma_kernel`` does), then the walk from the last chunk to the
  first, carrying dS' (as bf16 hi + lo between chunks in bfloat16): per
  chunk W^T, M^T, R^T and Z^T from G^T = B C^T and Q^T = x dy^T masked
  before the exp, dx, the per-head dB and dC, the row and column sums of
  Z^T, v_s = B_s . (dS' x_s), dcum reduced into ddt and da_log, and the
  update dS' <- exp(T) dS' + (C o exp(cum))^T dy.  In bfloat16 every
  float32 operand of a product (W^T, M^T, S_k, dS', C o exp(cum)) enters
  as its bf16 hi + lo parts; in float32 (the FMA kernel) nothing is
  rounded.  dB and dC are summed over each group's heads, da_log and
  dd_skip over the batch rows.
* It is held to ``jax.vjp`` of the reference's ``ssd_chunked`` and to the
  port's ``ssd_scan_grad`` within 1e-5 * (1 + |ref|) in float32 and
  5e-2 * (1 + |ref|) in bfloat16 (``tests/test_torch_ssd_grad.py``'s
  tolerances), over 1 and 2 B/C groups, ragged lengths, with and without
  an initial state and a cotangent on the final state.
* The device rule of ``SsdScanFn``'s backward: a CPU tensor runs the plain
  backward (no kernel counted), a meta tensor notes the backward kernel's
  work (``ssd_scan_grad_work``) and allocates only the needed gradients
  (inside ``_build.plain_on_meta`` it runs the plain backward's ops), and
  any other device raises.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.ssm_scan import ops as SS

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
L = SS.KERNEL_CHUNK


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t, on):
    """t as its bf16 hi + lo parts (their float32 sum), or t itself."""
    if not on:
        return t
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def reverse_scan_numerics(x, dt, a_log, b, c, d_skip, init, dy, dstate):
    """The backward kernels' arithmetic (the mma kernel's splits in
    bfloat16, none in float32): (dx, ddt, da_log, db, dc, dd_skip,
    dinit), each in its input's dtype (dinit None without init)."""
    split = x.dtype == torch.bfloat16
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // L)
    pad = nc * L - s

    def chunks(t):  # (B, S, H, w) -> (B, nc, L, H, w), zeros past S
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(bs, nc, L, h, t.shape[-1])

    xf, dyf = chunks(x), chunks(dy)
    bf = chunks(SS.expand_groups(b, h, 2))
    cf = chunks(SS.expand_groups(c, h, 2))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bs, nc, L, h)
    a = -torch.exp(a_log.float())
    cum = torch.cumsum(dtf * a, dim=2)  # (B, nc, L, H)
    total = cum[:, :, -1]
    el = torch.exp(total[:, :, None] - cum)
    u = el * dtf

    # the forward's saved states: S_k before chunk k (B u split in bf16)
    state = (torch.zeros((bs, h, n, p)) if init is None
             else init.float().clone())
    saved = []
    for k in range(nc):
        saved.append(state)
        ub = _split(u[:, k, :, :, None] * bf[:, k], split)
        state = (torch.exp(total[:, k])[..., None, None] * state
                 + torch.einsum("bshn,bshp->bhnp", ub, xf[:, k]))

    upper = torch.ones((L, L), dtype=torch.bool).triu()  # (s, t): t >= s
    ds_c = (torch.zeros((bs, h, n, p)) if dstate is None
            else _split(dstate.float(), split))
    dx, db, dc, ddt = [], [], [], []
    da = torch.zeros((bs, h))
    dd = torch.zeros((bs, h))
    for k in reversed(range(nc)):
        xk, dyk, bk, ck = xf[:, k], dyf[:, k], bf[:, k], cf[:, k]
        cumk = cum[:, k].permute(0, 2, 1)  # (B, H, L)
        dtk = dtf[:, k].permute(0, 2, 1)
        uk, elk = u[:, k].permute(0, 2, 1), el[:, k].permute(0, 2, 1)
        eT = torch.exp(total[:, k])[..., None]
        sk = _split(saved[k], split)
        # the s rows: W^T, M^T, R^T and Z^T over t >= s
        gT = torch.einsum("bshn,bthn->bhst", bk, ck)
        qT = torch.einsum("bshp,bthp->bhst", xk, dyk)
        ldiff = cumk[..., None, :] - cumk[..., :, None]  # cum_t - cum_s
        lam = torch.where(upper, torch.exp(torch.where(upper, ldiff, 0.0)),
                          0.0)
        wT = _split(gT * lam * dtk[..., None], split)
        mT = _split(qT * lam * dtk[..., None], split)
        rT = gT * lam * qT
        zT = rT * dtk[..., None]
        xs = torch.einsum("bshp,bhnp->bhsn", xk, ds_c)
        v = torch.einsum("bshn,bhsn->bhs", bk, xs)
        dxk = (torch.einsum("bhst,bthp->bshp", wT, dyk)
               + (uk[..., None] * torch.einsum("bshn,bhnp->bhsp", bk,
                                              ds_c)).permute(0, 2, 1, 3)
               + d_skip.float()[None, None, :, None] * dyk)
        dbk = (torch.einsum("bhst,bthn->bshn", mT, ck)
               + (uk[..., None] * xs).permute(0, 2, 1, 3))
        ic = torch.einsum("bthp,bhnp->bhtn", dyk, sk)
        eck = torch.exp(cumk)
        dck = (torch.einsum("bhst,bshn->bthn", mT, bk)
               + (eck[..., None] * ic).permute(0, 2, 1, 3))
        inter = eck * torch.einsum("bthn,bhtn->bht", ck, ic)
        dcum = -zT.sum(-1) - uk * v + zT.sum(-2) + inter
        dcum[..., -1] += (eT[..., 0] * (saved[k] * ds_c).sum((-1, -2))
                          + (uk * v).sum(-1))
        rc = dcum.flip(-1).cumsum(-1).flip(-1)
        ddt.append(rT.sum(-1) + elk * v + a[:, None] * rc)
        da += (dtk * rc).sum(-1)
        dd += (xk * dyk).sum((1, 3))
        dx.append(dxk)
        db.append(dbk)
        dc.append(dck)
        ce = _split(ck * eck.permute(0, 2, 1)[..., None], split)
        ds_c = _split(eT[..., None] * ds_c
                      + torch.einsum("bthn,bthp->bhnp", ce, dyk), split)

    def whole(parts):  # chunks (last first) -> (B, S, H, w)
        return torch.cat(parts[::-1], dim=1)[:, :s]

    def group_sum(t):
        return t.reshape(bs, s, g, h // g, n).sum(3).to(b.dtype)

    ddt_all = torch.cat(ddt[::-1], dim=-1)[..., :s].permute(0, 2, 1)
    return (whole(dx).to(x.dtype), ddt_all, (a * da).sum(0),
            group_sum(whole(db)), group_sum(whole(dc)), dd.sum(0),
            None if init is None else ds_c)


def _arrays(seed, b, s, h, p, g, n, init):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"x": f(b, s, h, p),
            "dt": (0.01 + 0.09 * rng.random((b, s, h))).astype(np.float32),
            "a_log": 0.5 * f(h), "b": 0.3 * f(b, s, g, n),
            "c": 0.3 * f(b, s, g, n), "d_skip": 1 + 0.2 * f(h),
            "init": 0.5 * f(b, h, n, p) if init else None,
            "dy": f(b, s, h, p), "dstate": f(b, h, n, p)}


def _torch(a, dtype):
    out = []
    for name in ("x", "dt", "a_log", "b", "c", "d_skip", "init"):
        t = None if a[name] is None else torch.from_numpy(a[name].copy())
        if name in ("x", "b", "c"):
            t = t.to(dtype)
        out.append(t)
    return out


def _excess(got, want, tol):
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item() / tol


# (b, s, h, p, g, n, chunk of the reference, initial state, dstate):
# ragged lengths (100, 72: not multiples of 64), 1 and 2 groups
CASES = [(2, 128, 4, 16, 1, 16, 64, False, True),
         (1, 100, 4, 32, 2, 16, 50, True, True),
         (2, 72, 6, 16, 2, 32, 72, True, False),
         (1, 192, 2, 32, 1, 32, 64, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_reverse_scan_numerics_match_the_references_vjp(dtype, case):
    b, s, h, p, g, n, chunk, init, with_dstate = case
    a = _arrays(s * h + n, b, s, h, p, g, n, init)
    jd = JDT[dtype]
    prim = [jnp.asarray(a["x"], jd), jnp.asarray(a["dt"]),
            jnp.asarray(a["a_log"]), jnp.asarray(a["b"], jd),
            jnp.asarray(a["c"], jd), jnp.asarray(a["d_skip"])]
    if init:
        prim.append(jnp.asarray(a["init"]))

    def ref(*args):
        return ssd_chunked(*args[:6], chunk,
                           initial_state=args[6] if init else None)

    dstate = a["dstate"] if with_dstate else np.zeros_like(a["dstate"])
    want = jax.jit(lambda pr, dy, dst: jax.vjp(ref, *pr)[1]((dy, dst)))(
        prim, jnp.asarray(a["dy"], jd), jnp.asarray(dstate))
    ins = _torch(a, dtype)
    dy = torch.from_numpy(a["dy"]).to(dtype)
    got = reverse_scan_numerics(*ins, dy, torch.from_numpy(dstate)
                                if with_dstate else None)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for i, (g_, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(w, np.float32))
        assert g_.shape == w.shape, i
        assert _excess(g_, w, TOL[dtype]) <= 1, (i, _excess(g_, w,
                                                            TOL[dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES[1:3])
def test_reverse_scan_numerics_match_the_plain_backward(dtype, case):
    b, s, h, p, g, n, chunk, init, with_dstate = case
    a = _arrays(s + h, b, s, h, p, g, n, init)
    ins = _torch(a, dtype)
    dy = torch.from_numpy(a["dy"]).to(dtype)
    dstate = torch.from_numpy(a["dstate"]) if with_dstate else None
    got = reverse_scan_numerics(*ins, dy, dstate)
    want = SS.ssd_scan_grad(*ins, dy, dstate, chunk)
    for i, (g_, w) in enumerate(zip(got, want)):
        if w is None:
            assert g_ is None
            continue
        assert g_.dtype == w.dtype and g_.shape == w.shape, i
        assert _excess(g_, w, TOL[dtype]) <= 1, (i, _excess(g_, w,
                                                            TOL[dtype]))


def test_carrying_ds_as_hi_lo_tracks_float32():
    """The bf16 kernel keeps dS' between chunks as bf16 hi + lo: over 8
    chunks its initial-state gradient stays within 1e-4 * (1 + |ref|) of
    the float32 walk on the same bf16 inputs."""
    a = _arrays(5, 1, 512, 2, 32, 1, 32, True)
    ins = _torch(a, torch.bfloat16)
    dy = torch.from_numpy(a["dy"]).to(torch.bfloat16)
    dstate = torch.from_numpy(a["dstate"])
    got = reverse_scan_numerics(*ins, dy, dstate)[-1]
    f32 = [None if t is None else t.float() for t in ins]
    want = reverse_scan_numerics(*f32, dy.float(), dstate)[-1]
    assert _excess(got, want, 1e-4) <= 1, _excess(got, want, 1e-4)


# -- the device rule --------------------------------------------------------

def _fn_grads(ins, dy, chunk=16):
    leaves = [None if t is None else t.clone().requires_grad_(True)
              for t in ins]
    y, _ = SS.SsdScanFn.apply(*leaves, chunk)
    want = [t for t in leaves if t is not None]
    return torch.autograd.grad(y, want, dy)


def test_cpu_backward_is_the_plain_backward():
    a = _arrays(9, 2, 40, 4, 16, 2, 16, True)
    ins = _torch(a, torch.float32)
    dy = torch.from_numpy(a["dy"])
    reset_launch_counts()
    got = _fn_grads(ins, dy)
    want = SS.ssd_scan_grad(*ins, dy, None, 16)
    assert all(torch.equal(g_, w) for g_, w in zip(got, want))
    assert set(launch_counts().values()) == {0}


def test_meta_backward_notes_the_kernels_work():
    b, s, h, p, g, n = 2, 200, 8, 64, 1, 64
    meta = dict(device="meta")
    x = torch.empty((b, s, h, p), dtype=torch.bfloat16, **meta)
    bc = torch.empty((b, s, g, n), dtype=torch.bfloat16, **meta)
    ins = [x, torch.empty((b, s, h), **meta), torch.empty((h,), **meta), bc,
           torch.empty_like(bc), torch.empty((h,), **meta), None]
    with _build.record_meta_work() as work:
        grads = _fn_grads(ins, torch.empty_like(x), 128)
    assert [t.shape for t in grads] == [t.shape for t in ins if t is not None]
    noted = {name: (f, nb) for name, f, nb in work}
    assert noted["ssd_scan_bwd"] == SS.ssd_scan_grad_work(b, s, h, g, p, n, 2)
    with _build.plain_on_meta(), _build.record_meta_work() as plain:
        _fn_grads(ins, torch.empty_like(x), 128)
    assert plain == []


def test_grad_work_counts_the_minimal_backward():
    """At the kernel's chunk of 64 (S = 100: two chunks): 2 L^2 (3 N + 2 P)
    + 8 L N P a (row, head, chunk); bytes of x, b, c, dy, dt, a_log,
    d_skip, the chunk states, the gradients."""
    flops, nbytes = SS.ssd_scan_grad_work(2, 100, 4, 1, 16, 32, 2)
    assert flops == 2 * 4 * 2 * (2 * 64 ** 2 * (3 * 32 + 2 * 16)
                                 + 8 * 64 * 32 * 16)
    act = 2 * (2 * 2 * 100 * 4 * 16 + 2 * 2 * 100 * 1 * 32)
    grads = 2 * (2 * 100 * 4 * 16 + 2 * 2 * 100 * 1 * 32)
    f32 = 4 * (2 * 100 * 4 + 8) * 2 + 4 * 2 * 4 * 2 * 32 * 16
    assert nbytes == act + grads + f32


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_raise():
    a = _arrays(11, 1, 16, 2, 16, 1, 16, False)
    ins = [None if t is None else t.as_subclass(_Elsewhere)
           for t in _torch(a, torch.float32)]
    with pytest.raises(ValueError, match="unsupported device"):
        SS._scan_grad(*ins, None, ins[0], None, 16, (True,) * 7)
