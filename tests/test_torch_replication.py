"""The mesh half of RDP on ``torch.distributed`` against the reference.

* ``aggregate_host`` equals the reference's bit for bit: the cases of
  ``tests/test_replication.py`` and seeded random trees (numpy float64 and
  float32, and torch tensors) with dead workers and rate-aware
  ``worker_batch`` maps.
* Eight gloo ranks (one process each, spawned once for the module) run
  the reference's 8-device ``shard_map`` case (r = 2, B = 4) on
  ``make_rdp_mesh`` / ``aggregate_gradients`` / the collectives; the
  reference's own subprocess script (``tests/test_replication.py``), run
  beside them and extended to print its outputs, gives the values each
  rank is held to within rtol 1e-6.
* Recording the groups every collective ran on shows that the steady-state
  paths (``hierarchical`` mode, ``replication_aware_pmean``,
  ``hierarchical_allreduce``) never touch the replica group.
* ``allreduce_bytes`` equals the reference's in every mode.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import replication as RR
from repro.core.policies import rate_aware_assignment
from repro.distributed import collectives as RC
from repro_torch.core import replication as TR
from repro_torch.distributed import collectives as TC

import test_replication as REF_TESTS

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RTOL = 1e-6
WORLD = 8

# the reference script's variables (out, nb, fh, fp, g, alive, mesh, spec)
# printed, plus the tree cases the ranks run
_REF_EXTRA = """
import json
from repro.core.replication import aggregate_gradients
tspec = {"w": P((REPLICA_AXIS, BATCH_AXIS), None), "b": [spec, spec]}
tree = {
    "w": jnp.concatenate([jnp.arange(6.0).reshape(2, 3) * (i + 1)
                          for i in range(8)]),
    "b": [jnp.asarray([i * 0.5 - 1.0 for i in range(8)], jnp.float32),
          jnp.concatenate([jnp.full((2,), i ** 0.5) for i in range(8)])],
}
alive2 = jnp.ones(8, jnp.float32).at[0].set(0.)
f2 = jax.jit(shard_map(lambda t, a: aggregate_gradients(t, a, mode="weighted"),
                       mesh=mesh, in_specs=(tspec, spec),
                       out_specs=(tspec, spec)))
out2, nb2 = f2(tree, alive2)
f3 = jax.jit(shard_map(lambda t: aggregate_gradients(t, mode="psum_all")[0],
                       mesh=mesh, in_specs=(tspec,), out_specs=tspec))
ft = jax.jit(shard_map(hierarchical_allreduce, mesh=mesh, in_specs=(tspec,),
                       out_specs=tspec))
fq = jax.jit(shard_map(replication_aware_pmean, mesh=mesh, in_specs=(tspec,),
                       out_specs=tspec))
def tolist(t):
    return jax.tree.map(lambda x: np.asarray(x, np.float64).tolist(), t)
print("REF_JSON" + json.dumps({
    "weighted": tolist(out), "n_batches_used": tolist(nb),
    "hier": tolist(fh(g)), "pmean": tolist(fp(g)),
    "weighted_tree": tolist(out2), "n_batches_used_tree": tolist(nb2),
    "psum_all": tolist(f3(tree)), "hier_tree": tolist(ft(tree)),
    "pmean_tree": tolist(fq(tree))}))
"""


def _rank_tree(ref, r):
    """Rank r's block of a reference tree output (rank-major blocks)."""
    return {"w": np.asarray(ref["w"])[2 * r:2 * r + 2],
            "b": [np.asarray(ref["b"][0])[r:r + 1],
                  np.asarray(ref["b"][1])[2 * r:2 * r + 2]]}


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float64), ref,
                               rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the eight gloo ranks and, beside it, one run of the
    reference's subprocess script: ({rank: results}, reference outputs)."""
    tmp = tmp_path_factory.mktemp("rdp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_TESTS._SUBPROCESS_SCRIPT + _REF_EXTRA],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in ranks]
        ref_out, ref_err = ref.communicate(timeout=180)
    finally:
        for p in (*ranks, ref):
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(ranks):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    assert ref.returncode == 0, ref_err[-3000:]
    assert "SUBPROCESS_OK" in ref_out
    ref_json = json.loads(ref_out.split("REF_JSON", 1)[1])
    port = {r: torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)}
    return port, ref_json


# ------------------------------------------------------------ aggregate_host
def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_tree(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same_tree(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _same_tree(p, r)
    else:
        _same_bits(port.numpy() if torch.is_tensor(port) else port,
                   ref.numpy() if torch.is_tensor(ref) else ref)


def test_aggregate_host_reference_cases_bit_equal():
    """tests/test_replication.py's unbiased-mean cases, both packages."""
    rplan, tplan = RR.ReplicationPlan(8, 4), TR.ReplicationPlan(8, 4)
    grads = [{"w": np.full(3, float(RR.batch_index_for_data_coord(rplan, w)))}
             for w in range(8)]
    alive = np.ones(8, bool)
    for dead in ((), (0,), (2, 6)):
        a = alive.copy()
        a[list(dead)] = False
        ref, nb_r = RR.aggregate_host(grads, a, rplan)
        port, nb_p = TR.aggregate_host(grads, a, tplan)
        _same_tree(port, ref)
        assert nb_p == nb_r
    np.testing.assert_allclose(port["w"], (0 + 1 + 3) / 3)
    assert nb_p == 3
    with pytest.raises(RuntimeError):
        TR.aggregate_host([None] * 4, np.zeros(4, bool),
                          TR.ReplicationPlan(4, 2))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["float64", "float32", "torch"])
def test_aggregate_host_random_trees_bit_equal(seed, kind):
    """Seeded nested trees, dead workers, a missing gradient, and a
    rate-aware worker->batch map: the port's result is the reference's
    bit for bit (numpy and torch leaves alike)."""
    rng = np.random.default_rng(seed)
    n, b = (12, 4) if seed % 2 else (16, 8)
    dtype = np.float32 if kind == "float32" else np.float64

    def tree(w):
        return {"w": rng.standard_normal((3, 4)).astype(dtype),
                "b": [rng.standard_normal(5).astype(dtype),
                      {"c": rng.standard_normal((2, 2)).astype(dtype)}]}

    grads = [tree(w) for w in range(n)]
    grads[int(rng.integers(n))] = None
    alive = rng.random(n) > 0.3
    rates = tuple(rng.uniform(0.2, 1.5, n))
    worker_batch = (rate_aware_assignment(n, b, rates).worker_batch
                    if seed % 3 else None)
    conv = (lambda t: torch.utils._pytree.tree_map(torch.from_numpy, t)) \
        if kind == "torch" else (lambda t: t)
    ref, nb_r = RR.aggregate_host(grads, alive, RR.ReplicationPlan(n, b),
                                  worker_batch=worker_batch)
    port, nb_p = TR.aggregate_host([None if g is None else conv(g)
                                    for g in grads], alive,
                                   TR.ReplicationPlan(n, b),
                                   worker_batch=worker_batch)
    assert nb_p == nb_r
    _same_tree(port, ref)


# ------------------------------------------------------------- gloo ranks
def test_mesh_is_replica_major(runs):
    port, _ = runs
    assert port[0]["mesh"] == [[[0], [1], [2], [3]], [[4], [5], [6], [7]]]
    for r in range(WORLD):
        assert port[r]["coord"] == [r // 4, r % 4, 0]


def test_weighted_mean_renormalizes_over_surviving_batches(runs):
    port, ref = runs
    for r in range(WORLD):
        _close(port[r]["weighted"], np.asarray(ref["weighted"])[r:r + 1])
        assert float(port[r]["n_batches_used"]) == 3.0
        assert ref["n_batches_used"][r] == 3.0
        np.testing.assert_allclose(port[r]["weighted"].numpy(),
                                   (0 + 1 + 3) / 3, rtol=RTOL)


def test_weighted_tree_with_a_dead_replica(runs):
    port, ref = runs
    for r in range(WORLD):
        want = _rank_tree(ref["weighted_tree"], r)
        got = port[r]["weighted_tree"]
        _close(got["w"], want["w"])
        _close(got["b"][0], want["b"][0])
        _close(got["b"][1], want["b"][1])
        assert float(port[r]["n_batches_used_tree"]) == 4.0
        assert port[r]["inputs_unchanged"]


@pytest.mark.parametrize("key", ["psum_all", "hier_tree", "pmean_tree"])
def test_tree_collectives_match_the_reference(runs, key):
    port, ref = runs
    for r in range(WORLD):
        want = _rank_tree(ref[key], r)
        got = port[r][key]
        _close(got["w"], want["w"])
        _close(got["b"][0], want["b"][0])
        _close(got["b"][1], want["b"][1])


@pytest.mark.parametrize("key", ["hier", "pmean", "hierarchical_mode"])
def test_steady_state_means_match_the_reference(runs, key):
    """hierarchical_allreduce == replication_aware_pmean == the
    hierarchical mode, each the reference's (3, 1) tile at rank r."""
    port, ref = runs
    for r in range(WORLD):
        got = port[r][key]["w"]
        assert got.shape == (3, 1)
        _close(got, np.asarray(ref["hier" if key != "pmean" else "pmean"])
               [:, r:r + 1])
        _close(got, np.asarray(ref["pmean"])[:, r:r + 1])


def test_steady_state_never_touches_the_replica_group(runs):
    port, _ = runs
    for r in range(WORLD):
        groups = port[r]["steady_groups"]
        assert groups, "no collective was recorded"
        names = {name for name, _ in groups}
        assert names == {"all_reduce", "reduce_scatter_tensor",
                         "all_gather_into_tensor"}
        for _, ranks in groups:
            assert {x // 4 for x in ranks} == {r // 4}, ranks
        # the recording sees the replica group where it is used
        assert any(len({x // 4 for x in ranks}) > 1
                   for _, ranks in port[r]["psum_all_groups"])


# ------------------------------------------------------------- byte model
@pytest.mark.parametrize("mode", ["plain", "rdp", "weighted"])
@pytest.mark.parametrize("n,b", [(32, 16), (8, 1), (12, 12), (1024, 256)])
def test_allreduce_bytes_equal_the_reference(mode, n, b):
    g = 10 * 2**20 + 7
    assert TC.allreduce_bytes(g, TR.ReplicationPlan(n, b), mode) == \
        RC.allreduce_bytes(g, RR.ReplicationPlan(n, b), mode)
    with pytest.raises(ValueError):
        TC.allreduce_bytes(g, TR.ReplicationPlan(n, b), "ring")


def test_rdp_data_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert TR.rdp_data_spec() == (Replicate(), Shard(0), Replicate())
    assert TR.rdp_data_spec(None, "model") == (Replicate(), Shard(0),
                                               Shard(2))
    with pytest.raises(ValueError):
        TR.rdp_data_spec("replica")
