"""Each cell kind's control, the reference in the precision below the one
its configuration states, departs from the reference by more than the
program does: TF32 for the CNN's float32 (card only: TF32 exists only
there), fp8 for the LM's bfloat16 (emulated, so also on the CPU).  At a
size a test run can hold; the cells' own readings are in PERF.md."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import fedbench_tiny as tiny  # noqa: E402

from fedbench import calibrate, harness  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an H100 (compute capability 9.0)")
    return torch.device("cuda", 0)


def _readings(root, cell_name, device, **traffic):
    cell = harness.find_cell(cell_name, root, root / "fedbench")
    cell.traffic.update(traffic)
    cell.device = device
    got = {kind: vals for _, kind, vals, _ in calibrate.readings(
        cell, [4_000_000_077], control=True, faults=(),
        here=root / "fedbench")}
    return got["sound"], got["control"]


@pytest.mark.cuda
def test_tf32_control_departs_on_the_card(card, tmp_path):
    root = tiny.tiny_copy(tmp_path)
    sound, low = _readings(root, "mnist-cnn.w30-sync", card, workers=4,
                           images_per_worker=500)
    assert any(low[k] > 3 * sound[k] + 1e-9 for k in sound)


def test_fp8_control_departs_from_the_pods_reference(tmp_path):
    root = tiny.tiny_copy(tmp_path)
    sound, low = _readings(root, "musicgen-pods.raw-h10",
                           torch.device("cpu"))
    assert any(low[k] > 3 * sound[k] for k in sound)
