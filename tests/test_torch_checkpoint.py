"""The port's ``Checkpointer`` against the reference's on-disk layout.

The cases of ``tests/test_optim_checkpoint.py`` (round trip, async writes
and garbage collection, a given step, a leaf mismatch, a missing
checkpoint), on the port's trees of tensors, with bfloat16 leaves and the
optimizer state of ``repro_torch.optim``.  A checkpoint of one tree
written by either package restores in the other, bit for bit (bf16 stored
as uint16 bits with its true dtype in the manifest, leaves numbered with
dict keys sorted), and the port restores without ``ml_dtypes`` (a
subprocess where importing it fails).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.optim import init
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((8, 4), generator=g).to(torch.bfloat16),
              "b": [torch.zeros(4), torch.randn(3, generator=g)]}
    return {"params": params, "opt": init(params)}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_with_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(10, st, {"plan_batches": 4})
    restored, meta = ck.restore(_state(seed=1))
    assert meta["plan_batches"] == 4
    _equal(restored, st)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert latest_step(tmp_path) == 10
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json")
                          .read_text())
    # leaves numbered with dict keys sorted: opt/{m, master, step, v} (3 +
    # 3 + 1 + 3), then params/{b (2), w}
    assert manifest["n_leaves"] == 3 * 3 + 1 + 3
    assert manifest["dtypes"][-1] == "bfloat16"  # params/w, the last leaf
    with np.load(tmp_path / "step_00000010" / "leaves.npz") as data:
        assert data["leaf_00012"].dtype == np.uint16
        assert data["leaf_00006"].shape == ()  # opt/step


def test_restore_casts_to_the_example(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.arange(6, dtype=torch.float32)})
    out, _ = ck.restore({"a": torch.zeros(6, dtype=torch.bfloat16)})
    assert out["a"].dtype == torch.bfloat16
    assert out["a"].float().tolist() == list(range(6))


def test_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _state(s), {"s": s})
    ck.wait()
    assert latest_step(tmp_path) == 4
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_00000003", "step_00000004"]
    restored, meta = ck.restore(_state())
    assert meta["s"] == 4
    _equal(restored, _state(4))


def test_save_async_copies_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = {"a": torch.ones(1000)}
    ck.save_async(1, st)
    st["a"].zero_()  # the caller's next step overwrites its tensors
    ck.wait()
    out, _ = ck.restore({"a": torch.zeros(1000)})
    assert float(out["a"].sum()) == 1000.0


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (5, 6):
        ck.save(s, _state(s), {"s": s})
    out, meta = ck.restore(_state(), step=5)
    assert meta["s"] == 5
    _equal(out, _state(5))


def test_leaf_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.zeros(3), "b": torch.zeros(2)})


def test_missing_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore({"a": torch.zeros(1)})
    assert latest_step(tmp_path / "nowhere") is None


def _mixed(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    return {"w": w.astype(ml_dtypes.bfloat16), "z": rng.standard_normal(5)
            .astype(np.float32), "k": np.arange(3, dtype=np.int32)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed(0)
    RefCheckpointer(str(tmp_path)).save(
        3, {k: jnp.asarray(v) for k, v in tree.items()},
        {"step": 3})
    example = {"w": torch.zeros((8, 4), dtype=torch.bfloat16),
               "z": torch.zeros(5), "k": torch.zeros(3, dtype=torch.int32)}
    out, meta = Checkpointer(str(tmp_path)).restore(example)
    assert meta == {"step": 3}
    assert np.array_equal(out["w"].view(torch.int16).numpy(),
                          tree["w"].view(np.int16))
    assert np.array_equal(out["z"].numpy(), tree["z"])
    assert np.array_equal(out["k"].numpy(), tree["k"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _mixed(1)
    state = {"w": torch.from_numpy(tree["w"].view(np.int16)).view(torch.bfloat16),
             "z": torch.from_numpy(tree["z"]), "k": torch.from_numpy(tree["k"])}
    Checkpointer(str(tmp_path)).save(7, state, {"plan_batches": 2})
    example = {k: jnp.zeros(v.shape, v.dtype) for k, v in tree.items()}
    out, meta = RefCheckpointer(str(tmp_path)).restore(example)
    assert meta == {"plan_batches": 2}
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert np.array_equal(np.asarray(out[k]).view(np.uint8),
                              tree[k].view(np.uint8))


def test_restore_needs_no_ml_dtypes(tmp_path):
    code = "\n".join([
        "import sys",
        "sys.modules['ml_dtypes'] = None",
        f"sys.path.insert(0, {os.path.abspath(SRC)!r})",
        "import torch",
        "from repro_torch.checkpoint import Checkpointer",
        f"ck = Checkpointer({str(tmp_path)!r})",
        "x = torch.randn(16).to(torch.bfloat16)",
        "ck.save(1, {'x': x})",
        "out, _ = ck.restore({'x': torch.zeros(16, dtype=torch.bfloat16)})",
        "assert torch.equal(out['x'], x)",
        "assert 'ml_dtypes' not in [k for k, v in sys.modules.items() if v]",
        "print('restored')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "restored" in out.stdout
