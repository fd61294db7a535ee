"""The check that decides ``correct`` fails a run whose timed path is
broken underneath: each fault a cell can have, planted in the program, on
the CPU at a tiny size (the chip's look skipped)."""

import pytest
import tiny_copy


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell, fault", [
    ("olmoe.train", "unchanged_state"),
    ("olmoe.train", "half_batch"),
    ("olmoe.prefill", "altered_token"),
])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    line, _, _ = tiny_copy.run(tiny, cell, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
