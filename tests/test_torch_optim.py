"""The port's AdamW, schedules and int8 compression against the reference's.

The same float32 trees (made with numpy from a seed) go through
``repro.optim`` and ``repro_torch.optim``:

* ``update`` is bit-equal to the reference's run op by op (not jitted)
  over five steps when the clip scale is 1: moments, master, params (float32
  and bf16), step.  Jitted, as the reference's trainer runs it, XLA on the
  CPU contracts each multiply-add into one FMA (``b1 * m + (1 - b1) * g``
  becomes ``fma(b1, m, (1 - b1) * g)``), and with clipping the global norm
  is a sum over leaves in another order, so its last bits and the clip
  scale's differ: the moments and master then lie within 8 float32
  spacings of each leaf's largest value (measured: 3).
* The float32 square root of the update (``adamw.sqrt_``) is correctly
  rounded, as ``np.sqrt`` and ``jnp.sqrt`` are: float32 ``torch.sqrt`` on
  the CPU is not on every host (on an AMD EPYC host, torch 2.13, 715 of
  the 4,096 values below were one spacing off), and one such value at
  step 2 broke the op-by-op equality.
* The bias corrections are ``1 - b ** step`` with a float32 power: equal
  to the reference's at all but one of the first 5,000 steps for each of
  b1 and b2, and there within one float32 spacing of the result or of
  ``b ** step`` (the power's last bit differs; the
  float64 power of a Python ``b ** step`` differs at 35 and 71 of them).
* ``warmup_cosine`` within 2 float32 spacings of the peak rate of the
  reference's at every step (the float32 cosines differ in their last bit
  at a few steps, and ``1 + cos`` near the end of the schedule keeps that
  difference absolute); ``constant`` equal.
* ``compress`` and ``compressed_reduce_host`` bit-equal on the same float32
  trees (``torch.round`` and ``jnp.round`` both round half to even).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefConfig
from repro.optim import constant as ref_constant
from repro.optim import init as ref_init
from repro.optim import update as ref_update
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.compression import compress as ref_compress
from repro.optim.compression import compressed_reduce_host as ref_reduce
from repro_torch.optim import (AdamWConfig, constant, global_norm, init,
                               update, warmup_cosine)
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress, compressed_reduce_host,
                                           decompress, init_error_state)
from repro_torch.tree import tree_leaves

SHAPES = {"a": (64, 32), "b": {"c": (17,), "d": [(5, 3, 4), (7,)]}}


def _tree(rng, scale):
    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(SHAPES)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _leaves(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in jax.tree.leaves(tree)]


def _run(scales, params_dtype=np.float32, seed=0, jit=True):
    """Both optimizers over len(scales) steps; gradients of those scales;
    the reference's update jitted or op by op."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: a.astype(params_dtype), _tree(rng, 1.0))
    rp = _jnp(p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16 if params_dtype != np.float32 else torch.float32), p)
    rs, ts = ref_init(rp), init(tp)
    step = lambda g, s, p, lr: ref_update(g, s, p, lr, RefConfig())  # noqa: E731
    step = jax.jit(step) if jit else step
    sched = ref_warmup_cosine(1e-3, 2, 10)
    out = []
    for i, sc in enumerate(scales):
        g = _tree(rng, sc)
        lr = np.float32(sched(i))
        rp, rs, rm = step(_jnp(g), rs, rp, jnp.float32(lr))
        tp, ts, tm = update(_torch(g), ts, tp, torch.tensor(lr))
        out.append((rp, rs, rm, tp, ts, tm))
    return out


def test_update_is_bit_equal_op_by_op_without_clipping():
    for rp, rs, rm, tp, ts, tm in _run([0.01, 0.02, 0.005, 0.01, 0.015],
                                       jit=False):
        assert float(rm["clip_scale"]) == float(tm["clip_scale"]) == 1.0
        assert int(rs["step"]) == int(ts["step"])
        assert ts["step"].dtype == torch.int32
        for name in ("m", "v", "master"):
            for a, b in zip(_leaves(rs[name]), _leaves(ts[name])):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(rp), _leaves(tp)):
            np.testing.assert_array_equal(a, b)


def test_float32_sqrt_is_correctly_rounded():
    x = (np.abs(np.random.default_rng(0).standard_normal(4096)) * 1e-4
         ).astype(np.float32)
    got = adamw.sqrt_(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.sqrt(x)))
    big = np.abs(np.random.default_rng(1).standard_normal(adamw._SQRT_CHUNK + 5)
                 ).astype(np.float32)  # more than one chunk
    np.testing.assert_array_equal(adamw.sqrt_(torch.from_numpy(big.copy())
                                              ).numpy(), np.sqrt(big))


def test_update_bf16_params_are_the_rounded_master():
    import ml_dtypes

    for rp, rs, _, tp, ts, _ in _run([0.01, 0.02, 0.005], jit=False,
                                     params_dtype=ml_dtypes.bfloat16):
        for a, b in zip(jax.tree.leaves(rp), tree_leaves(tp)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())


@pytest.mark.parametrize("scales", [[0.01, 0.02, 0.005, 0.01, 0.03],
                                    [3.0, 0.01, 5.0, 2.0, 4.0]])
def test_update_against_jitted_reference_within_float32_spacings(scales):
    for rp, rs, rm, tp, ts, tm in _run(scales):
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["clip_scale"]),
                                   float(rm["clip_scale"]), rtol=1e-6)
        for name in ("m", "v", "master"):
            for a, b in zip(_leaves(rs[name]), _leaves(ts[name])):
                bound = 8 * np.spacing(np.abs(a).max())
                assert np.abs(a - b).max() <= bound, (name, np.abs(a - b).max())


def test_grad_clip_and_global_norm():
    p = {"w": torch.zeros(4)}
    _, _, m = update({"w": torch.full((4,), 100.0)}, init(p), p, 0.1)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(m["clip_scale"]) == pytest.approx(1 / 200.0)
    g = _tree(np.random.default_rng(1), 1.0)
    ref = float(jax.jit(lambda t: jnp.sqrt(sum(
        jnp.sum(jnp.square(x)) for x in jax.tree.leaves(t))))(_jnp(g)))
    np.testing.assert_allclose(float(global_norm(_torch(g))), ref, rtol=1e-6)


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = init(params, cfg)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        params, state, _ = update({"w": g}, state, params, 0.05, cfg)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)
    assert int(state["step"]) == 300


@pytest.mark.parametrize("b", [0.9, 0.95])
def test_bias_correction_is_a_float32_power(b):
    steps = np.arange(1, 5001, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))(
        jnp.asarray(steps)))
    port = (1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                          torch.from_numpy(steps).float())).numpy()
    f64 = np.array([np.float32(1 - b ** int(s)) for s in steps])
    assert (port != ref).sum() <= 1
    assert (np.abs(port - ref)
            <= np.maximum(np.spacing(ref), np.spacing(1 - ref))).all()
    assert (f64 != ref).sum() > 10 * max((port != ref).sum(), 1)


def test_schedules_match_reference():
    ref, port = ref_warmup_cosine(3e-4, 20, 100), warmup_cosine(3e-4, 20, 100)
    for s in range(0, 121):
        r, t = np.float32(ref(s)), port(s)
        assert t.dtype == torch.float32
        assert abs(float(t) - float(r)) <= 2 * np.spacing(np.float32(3e-4)), s
    sch = warmup_cosine(1.0, 10, 100, final_frac=0.1)
    assert float(sch(0)) == 0.0
    assert float(sch(10)) == pytest.approx(1.0, abs=1e-3)
    assert float(sch(100)) == pytest.approx(0.1, abs=1e-3)
    assert float(constant(0.3)(57)) == float(np.float32(ref_constant(0.3)(57)))


def test_compress_is_bit_equal():
    rng = np.random.default_rng(2)
    for scale in (1e-6, 1.0, 300.0):
        g = (scale * rng.standard_normal(513)).astype(np.float32)
        e = (0.01 * scale * rng.standard_normal(513)).astype(np.float32)
        rq, rs, re = ref_compress(jnp.asarray(g), jnp.asarray(e))
        tq, ts, te = compress(torch.from_numpy(g), torch.from_numpy(e))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(rq), tq.numpy())
        assert float(rs) == float(ts)
        np.testing.assert_array_equal(np.asarray(re), te.numpy())
        rec = decompress(tq, ts)
        assert float((rec - torch.from_numpy(g + e)).abs().max()) <= (
            float(ts) * 0.5 + 1e-6 * scale)


def test_round_half_to_even_like_jnp():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], dtype=torch.float32)
    q, scale, _ = compress(g, torch.zeros_like(g))
    rq, rscale, _ = ref_compress(jnp.asarray(g.numpy()), jnp.zeros(6))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_compressed_reduce_host_is_bit_equal(n):
    rng = np.random.default_rng(n)
    gs = [_tree(rng, 1.0) for _ in range(n)]
    es = [_tree(rng, 0.01) for _ in range(n)]
    rmean, rerrs = ref_reduce([_jnp(g) for g in gs], [_jnp(e) for e in es])
    tmean, terrs = compressed_reduce_host([_torch(g) for g in gs],
                                          [_torch(e) for e in es])
    for a, b in zip(_leaves(rmean), _leaves(tmean)):
        np.testing.assert_array_equal(a, b)
    for re, te in zip(rerrs, terrs):
        for a, b in zip(_leaves(re), _leaves(te)):
            np.testing.assert_array_equal(a, b)


def test_error_feedback_converges():
    rng = np.random.default_rng(0)
    g_true = [{"w": torch.from_numpy(rng.standard_normal(128).astype(np.float32))}
              for _ in range(4)]
    errors = [init_error_state(g) for g in g_true]
    exact = torch.stack([g["w"] for g in g_true]).mean(0)
    total = torch.zeros(128)
    for _ in range(50):
        mean, errors = compressed_reduce_host(g_true, errors)
        total += mean["w"]
    torch.testing.assert_close(total / 50, exact, atol=1e-3, rtol=0)
