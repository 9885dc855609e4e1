"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program: each checked in a fresh process by
the top-level names in ``sys.modules``, compared whole."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = r"""
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
from fedbench import harness, compare, yardstick, run, calibrate
from fedbench.reference import cnn, lm, codec
from fedbench.drivers import fl, pods
for f in sorted((root / "fedbench" / "metrics").glob("*.py")):
    harness.reader(f.stem)
import repro_torch.core.experiment, repro_torch.core.federated
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fedbench.reference import cnn, lm, codec
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str):
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_no_jax_and_no_jax_package_anywhere():
    mods = _top_level(LOAD_ALL)
    assert "repro_torch" in mods and "fedbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    mods = _top_level(LOAD_REFERENCE)
    assert not mods & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name,bad", [("repro", True), ("repro_torch", False),
                                      ("jaxlib", True), ("jaxtyping", False)])
def test_forbidden_names_are_compared_whole(name, bad, monkeypatch):
    sys.path.insert(0, str(ROOT))
    from fedbench import harness
    monkeypatch.setitem(sys.modules, name + ".sub", object())
    found = harness.forbidden_modules()
    assert (name in found) == bad
