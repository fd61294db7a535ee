"""The port's SSD scan against the reference's, on the CPU.

On a CPU tensor ``repro_torch``'s ``ssd_scan`` runs its plain version
(``ssd_chunked`` with the reference model's chunk rule).  From the same
numpy inputs it is held against:

* the reference's Pallas kernel ``ssd_scan_kernel_call`` in interpret mode
  (``impl="pallas"``).  The kernel reads and writes its refs with
  ``pl.load`` and ``pl.store``, which the installed JAX no longer has; the
  fixture below supplies both for the test's duration as the indexed read
  and write they were.  The reference is unchanged;
* the reference's XLA twin ``ssd_chunked`` (ragged lengths through the
  chunk rule, G = H and G = 1, a non-zero initial state) and its oracle
  ``ssd_sequential``;
* and the port's own ``ssd_sequential`` against the reference's.

Inputs decay mildly (dt in [0.01, 0.1], A = -exp(a_log) near -1), so a
chunk of 16 keeps exp(total) in about [0.3, 0.9] and the state carried
across chunks matters (the reference's own sweep draws dt =
softplus(N(0, 1)), whose per-chunk decay falls below e^-20 and would hide a
broken inter-chunk path).  Tolerances are ``tests/test_kernels.py``'s: y
within 5e-5 (float32) or 5e-2 (bfloat16) absolute and relative, the final
state within 5e-3.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.ssm_scan.ops import ssd_scan as ref_ssd_scan
from repro.models import ssm as ref_ssm
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ssm_scan import (effective_chunk, ssd_scan,
                                          ssd_scan_plain, ssd_sequential)
from repro_torch.models import ssm as port_ssm

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}
STATE_TOL = dict(atol=5e-3, rtol=5e-3)


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


def _inputs(seed, b, s, h, p, g, n, init=False):
    """Mild-decay inputs as float32 numpy arrays."""
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


def _pair(arrs, dt):
    """(JAX args, torch args) of (x, dt, a_log, b, c, d_skip): x, b and c in
    the dtype ``dt``, the rest float32."""
    jdt, tdt = DT[dt]
    names = ("x", "dt", "a_log", "b", "c", "d_skip")
    low = {"x", "b", "c"}
    jx = [jnp.asarray(arrs[k], jdt if k in low else jnp.float32) for k in names]
    tx = [torch.from_numpy(arrs[k]).to(tdt if k in low else torch.float32)
          for k in names]
    return jx, tx


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               **tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 32, 1, 16, 16),   # four chunks, one B/C group
    (1, 48, 3, 16, 3, 32, 48),   # a single chunk, G = H
    (2, 32, 4, 16, 2, 16, 8),    # GQA-like grouping, 4 chunks
])
def test_plain_matches_pallas_interpret(pallas_refs, b, s, h, p, g, n, chunk):
    arrs = _inputs(0, b, s, h, p, g, n)
    jx, tx = _pair(arrs, "f32")
    ry, rs = ref_ssd_scan(*jx, chunk=chunk, impl="pallas")
    y, st = ssd_scan(*tx, chunk=chunk)
    _close(y, ry, **Y_TOL["f32"])
    _close(st, rs, **STATE_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", [
    (2, 64, 4, 32, 1, 16, 16, False),
    (2, 64, 4, 32, 4, 16, 16, True),    # G = H, initial state
    (1, 50, 2, 16, 1, 32, 16, False),   # ragged: one chunk of 50
    (1, 7, 2, 32, 2, 16, 128, True),    # shorter than a chunk
    (2, 1, 3, 16, 1, 16, 128, True),    # one position
    (1, 96, 2, 64, 1, 64, 32, True),    # zamba2's P = N = 64
])
def test_plain_matches_xla(dt, b, s, h, p, g, n, chunk, init):
    arrs = _inputs(1, b, s, h, p, g, n, init)
    jx, tx = _pair(arrs, dt)
    jinit = None if arrs["init"] is None else jnp.asarray(arrs["init"])
    tinit = None if arrs["init"] is None else torch.from_numpy(arrs["init"])
    ry, rs = ref_ssm.ssd_chunked(*jx, effective_chunk(s, chunk),
                                 initial_state=jinit)
    y, st = ssd_scan(*tx, tinit, chunk=chunk)
    assert y.dtype == DT[dt][1] and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, n, p)
    _close(y, ry, **Y_TOL[dt])
    _close(st, rs, **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n", [(2, 40, 4, 16, 2, 16),
                                         (1, 33, 2, 32, 1, 16)])
def test_sequential_oracles_agree(b, s, h, p, g, n):
    """The port's oracle against the reference's, and the plain chunked
    scan at several chunks against both (chunking is exact)."""
    arrs = _inputs(2, b, s, h, p, g, n)
    jx, tx = _pair(arrs, "f32")
    ry, rs = ref_ssm.ssd_sequential(*jx)
    y, st = ssd_sequential(*tx)
    _close(y, ry, **Y_TOL["f32"])
    _close(st, rs, **STATE_TOL)
    for chunk in (4, 8, s):
        cl = effective_chunk(s, chunk)
        yc, sc = ssd_scan_plain(*tx, chunk=chunk)
        assert s % cl == 0
        _close(yc, ry, **Y_TOL["f32"])
        _close(sc, rs, **STATE_TOL)


def test_inter_chunk_state_matters():
    """With mild decay, y past the first chunk depends on the state carried
    in: dropping it (a fresh scan of the second chunk alone) changes y far
    beyond the tolerance, and the initial state reproduces the split."""
    arrs = _inputs(3, 1, 32, 2, 16, 1, 16)
    _, tx = _pair(arrs, "f32")
    y, st = ssd_scan_plain(*tx, chunk=16)
    first = [t[:, :16].contiguous() if t.dim() > 1 else t for t in tx]
    second = [t[:, 16:].contiguous() if t.dim() > 1 else t for t in tx]
    y1, s1 = ssd_scan_plain(*first, chunk=16)
    y2, s2 = ssd_scan_plain(*second, s1, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(s2, st, atol=5e-5, rtol=5e-5)
    y2_fresh, _ = ssd_scan_plain(*second, chunk=16)
    assert (y2_fresh - y2).abs().max() > 1e-2


def test_strong_decay_stays_finite():
    """Where the unmasked exp(cum_t - cum_s) above the diagonal overflows
    (dt A of -50 a step), the masked form stays finite and matches the
    oracle: the state holds only the last step."""
    arrs = _inputs(4, 1, 32, 2, 16, 1, 16)
    arrs["dt"][:] = 50.0
    arrs["a_log"][:] = 0.0
    _, tx = _pair(arrs, "f32")
    y, st = ssd_scan_plain(*tx, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yq, sq = ssd_sequential(*tx)
    torch.testing.assert_close(y, yq, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, sq, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_matches_reference(g):
    rng = np.random.default_rng(5)
    b, h, p, n = 2, 4, 16, 16
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, h)).astype(np.float32)
    a_log = rng.standard_normal(h).astype(np.float32)
    bb = rng.standard_normal((b, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, g, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    args = (x, dt, a_log, bb, cc, d_skip)
    ry, rs = ref_ssm.ssd_decode_step(jnp.asarray(state),
                                     *(jnp.asarray(a) for a in args))
    st = torch.from_numpy(state.copy())
    y, out = port_ssm.ssd_decode_step(st, *(torch.from_numpy(a) for a in args))
    assert out is st  # updated in place
    _close(y, ry, atol=1e-5, rtol=1e-5)
    _close(st, rs, atol=1e-5, rtol=1e-5)


def test_conv_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    prev = rng.standard_normal((2, 3, 24)).astype(np.float32)
    for p in (None, prev):
        ref = ref_ssm._causal_depthwise_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            None if p is None else jnp.asarray(p))
        out = port_ssm._causal_depthwise_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            None if p is None else torch.from_numpy(p))
        _close(out, ref, atol=1e-5, rtol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    arrs = _inputs(7, 1, 8, 2, 16, 1, 16)
    _, (x, dt, a_log, b, c, d_skip) = _pair(arrs, "f32")
    with pytest.raises(ValueError, match="head dim P"):
        ssd_scan(torch.zeros((1, 8, 2, 24)), dt, a_log, b, c, d_skip)
    with pytest.raises(ValueError, match="state dim N"):
        ssd_scan(x, dt, a_log, torch.zeros((1, 8, 1, 8)),
                 torch.zeros((1, 8, 1, 8)), d_skip)
    with pytest.raises(ValueError, match="group"):
        ssd_scan(torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3)),
                 torch.zeros(3), torch.zeros((1, 8, 2, 16)),
                 torch.zeros((1, 8, 2, 16)), torch.zeros(3))
    with pytest.raises(TypeError, match="dt"):
        ssd_scan(x, dt.double(), a_log, b, c, d_skip)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.half(), dt, a_log, b.half(), c.half(), d_skip)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a_log, b,
                 c, d_skip)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, a_log, b, c, d_skip, torch.zeros((1, 2, 16, 8)))
    before = launch_counts()["ssd_scan"]
    ssd_scan(x, dt, a_log, b, c, d_skip)
    assert launch_counts()["ssd_scan"] == before  # CPU: the plain version
