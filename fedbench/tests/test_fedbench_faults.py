"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted under the window's own calls, at tiny size
on the CPU (the harness's look for a card skipped)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import fedbench_tiny as tiny  # noqa: E402


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.tiny_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault", [
    ("mnist-cnn.w30-sync", "unchanged"),
    ("mnist-cnn.w30-sync", "half_batch"),
    ("mnist-cnn.w30-sync", "altered"),
    ("musicgen-pods.raw-h10", "unchanged"),
    ("musicgen-pods.raw-h10", "half_batch"),
    ("musicgen-pods.raw-h10", "drop_pod"),
    ("musicgen-pods.topk-h1", "drop_pod"),
])
def test_a_planted_fault_is_not_correct(copy, cell, fault):
    rc, res = tiny.run(copy, cell, driver_kw={"fault": fault})
    assert rc == 0 and res is not None
    assert res["correct"] is False


def test_the_sound_run_is_correct(copy):
    rc, res = tiny.run(copy, "musicgen-pods.raw-h10")
    assert rc == 0 and res["correct"] is True
