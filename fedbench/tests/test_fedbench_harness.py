"""The harness is driven by data: a traffic mix and a per-layer metric added
as files (and entries of ``BENCHMARK.json``) are found by name, and each
driver's window runs at tiny sizes through the test-only entry.  The
command itself refuses to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import fedbench_tiny as tiny  # noqa: E402

DUMMY_METRIC = '''"""dummy_units: the plain window's units of work (a test metric)."""


def read(ctx):
    return ctx.window["units"]
'''


@pytest.fixture
def copy(tmp_path):
    return tiny.tiny_copy(tmp_path)


def _add_cell(dst: Path, base_cell: str, traffic: str, **changes) -> str:
    """A new traffic mix file (a copy of ``base_cell``'s with ``changes``),
    its limits file, a new cell in ``BENCHMARK.json``, and a dummy metric
    file listed for it."""
    fb = dst / "fedbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    base = next(w for w in bench["workloads"] if w["name"] == base_cell)
    mix = json.loads((fb / "traffic" / f"{base['traffic']}.json")
                     .read_text())
    mix.update(changes, name=traffic)
    (fb / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    cell = f"{base['config']}.{traffic}"
    (fb / "limits" / f"{cell}.json").write_text(
        (fb / "limits" / f"{base_cell}.json").read_text())
    bench["workloads"].append(dict(base, name=cell, traffic=traffic))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base_cell in m.get("workloads", ()):
            m["workloads"].append(cell)
    (fb / "metrics" / "dummy_units.py").write_text(DUMMY_METRIC)
    bench["per_layer"].append({
        "name": "dummy_units", "unit": "units", "better": "higher",
        "source": "host_clock", "layer": "whole step",
        "moves": bench["end_to_end"][0]["name"], "workloads": [cell]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("base,changes", [
    ("mnist-cnn.w30-sync", {"workers": 2, "images_per_worker": 32}),
    ("musicgen-pods.raw-h10", {"merge_every": 2, "rows_per_pod": 2}),
    ("musicgen-pods.topk-h1", {"frac": 0.2}),
])
def test_added_traffic_and_metric_are_found_by_name(copy, base, changes):
    cell = _add_cell(copy, base, "added-mix", **changes)
    rc, res = tiny.run(copy, cell, trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["dummy_units"]["value"] > 0
    rc, res = tiny.run(copy, cell, trace=0)
    assert rc == 0 and res["correct"] is True
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell", ["mnist-cnn.w30-sync",
                                  "musicgen-pods.topk-h1"])
def test_each_cell_reports_its_metrics_at_tiny_size(copy, cell):
    rc, res = tiny.run(copy, cell, trace=0)
    assert rc == 0 and res["correct"] is True and res["attempted"] > 0
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert res["device"]["count"] == 1


def test_the_command_exits_without_a_card(copy):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload",
         "mnist-cnn.w30-sync", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=copy, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
