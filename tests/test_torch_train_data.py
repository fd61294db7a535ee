"""The port's token pipeline against the reference's, bit for bit.

``repro_torch.data.TokenPipeline`` is a numpy copy of
``repro.data.TokenPipeline``: the same (seed, step) streams, so every
global batch, every batch of B and every data coordinate's shard must
equal the reference's exactly, dtype included.  The cases are those of
``tests/test_fault_elastic_data.py``: determinism, the partition of the
global batch, replica-group members getting identical data, shifted
labels; plus the shapes, a seeded sweep over (step, B) and the cells.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import SHAPE_CELLS as REF_SHAPE_CELLS
from repro.configs.base import ShapeCell as RefShapeCell
from repro.core import ReplicationPlan as RefPlan
from repro.data import TokenPipeline as RefPipeline
from repro.data import make_batch_shapes as ref_make_batch_shapes
from repro_torch.configs import SHAPE_CELLS, ShapeCell, get_config, reduced_config
from repro_torch.core import ReplicationPlan
from repro_torch.data import TokenPipeline, make_batch_shapes


def _pipes(gb=16, seq=32, seed=3, reduced=True):
    rcfg, cfg = ref_get_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    if reduced:
        rcfg, cfg = ref_reduced_config(rcfg), reduced_config(cfg)
    ref = RefPipeline(rcfg, RefShapeCell("t", seq, gb, "train"), seed=seed)
    port = TokenPipeline(cfg, ShapeCell("t", seq, gb, "train"), seed=seed)
    return ref, port


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_shape_cells_match_reference():
    assert SHAPE_CELLS == {k: ShapeCell(c.name, c.seq_len, c.global_batch,
                                        c.kind)
                           for k, c in REF_SHAPE_CELLS.items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_shapes_match_reference(kind):
    rcfg = ref_reduced_config(ref_get_config("qwen2-0.5b"))
    cfg = reduced_config(get_config("qwen2-0.5b"))
    assert (make_batch_shapes(cfg, ShapeCell("t", 64, 4, kind))
            == ref_make_batch_shapes(rcfg, RefShapeCell("t", 64, 4, kind)))


def test_unported_families_raise():
    """Named when the port refused the audio and vlm batches; it now holds
    that their shapes are the reference's, frames and patch embeddings
    included, in every cell kind."""
    for arch in ("whisper-medium", "internvl2-76b"):
        for reduced in (True, False):
            rcfg, cfg = ref_get_config(arch), get_config(arch)
            if reduced:
                rcfg, cfg = ref_reduced_config(rcfg), reduced_config(cfg)
            for kind in ("train", "prefill", "decode"):
                shapes = make_batch_shapes(cfg, ShapeCell("t", 512, 4, kind))
                assert shapes == ref_make_batch_shapes(
                    rcfg, RefShapeCell("t", 512, 4, kind))
                assert list(shapes) == list(ref_make_batch_shapes(
                    rcfg, RefShapeCell("t", 512, 4, kind)))


@pytest.mark.parametrize("step", [0, 7, 1000])
def test_global_batch_matches_reference(step):
    ref, port = _pipes()
    _equal(ref.global_batch(step), port.global_batch(step))
    _equal(port.global_batch(step), port.global_batch(step))  # deterministic


def test_full_vocab_stream_matches_reference():
    ref, port = _pipes(gb=8, seq=512, seed=0, reduced=False)
    _equal(ref.global_batch(5), port.global_batch(5))


@pytest.mark.parametrize("b_count", [1, 2, 4, 8, 16])
def test_batches_partition_like_reference(b_count):
    ref, port = _pipes()
    full = port.global_batch(3)
    rows = 16 // b_count
    for bid in range(b_count):
        shard = port.batch_for(3, bid, b_count)
        _equal(shard, ref.batch_for(3, bid, b_count))
        np.testing.assert_array_equal(
            shard["tokens"], full["tokens"][bid * rows:(bid + 1) * rows])


def test_indivisible_batch_count_raises():
    _, port = _pipes()
    with pytest.raises(ValueError, match="not divisible"):
        port.batch_for(0, 0, 3)


def test_replica_group_members_get_the_references_data():
    ref, port = _pipes()
    plan, rplan = ReplicationPlan(8, 4), RefPlan(n_data=8, n_batches=4)
    for w in range(8):
        partner = (w + 4) % 8  # same batch id (coord % 4)
        a = port.shard_for_coord(5, w, plan)
        _equal(a, port.shard_for_coord(5, partner, plan))
        _equal(a, ref.shard_for_coord(5, w, rplan))


def test_labels_are_shifted_tokens():
    ref, port = _pipes()
    g = port.global_batch(0)
    np.testing.assert_array_equal(g["labels"][:, :-1], g["tokens"][:, 1:])
    assert (g["labels"][:, -1] == 0).all()
    _equal(g, ref.global_batch(0))


def test_seeded_sweep_matches_reference():
    rng = np.random.default_rng(0)
    ref, port = _pipes()
    for _ in range(12):
        step = int(rng.integers(0, 10_000))
        b_count = int(rng.choice([1, 2, 4, 8, 16]))
        bid = int(rng.integers(0, b_count))
        _equal(ref.batch_for(step, bid, b_count),
               port.batch_for(step, bid, b_count))
