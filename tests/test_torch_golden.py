"""The port's whole main path against the golden histories: ``make_setup``
with the JAX package's initial weights exported as numpy, then ``run_fl``
at the fixtures' configuration (tests/golden/generate.py), on the CPU.

* ``raw/*``: time, version, n_updates, selected, up_bytes and down_bytes
  equal the fixture exactly; accuracy is within 4 of the 512 test samples
  at every point (f32 training is not bit-identical across frameworks).
* ``uplink_only/*``: parity is statistical, because a top-k tie can move
  ``kept`` by one: version, selected and down_bytes exact, up_bytes and
  time within 2%, accuracy within 4/512.

The fixtures were made with JAX's original (non-partitionable) threefry
PRNG, so the initial weights are drawn under it.

``PYTHONPATH=src python tests/test_torch_golden.py`` prints, per case,
the largest accuracy gap to the fixture (in test samples) and the largest
relative gaps in time and up_bytes.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models.mlp import init_mlp
from repro_torch.core import TABLE_4_1, make_setup, run_fl

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

TRANSPORTS = {
    "raw": dict(transport="raw"),
    "uplink_only": dict(transport="topk_ef+int8", transport_down="raw",
                        transport_frac=0.1),
}
CASES = [(t, m) for t in TRANSPORTS for m in _gen.MODES]
ACC_TOL = 4 / 512
EXACT = {"raw": ("time", "version", "n_updates", "selected", "up_bytes",
                 "down_bytes"),
         "uplink_only": ("version", "selected", "down_bytes")}
WITHIN_2PCT = {"raw": (), "uplink_only": ("time", "up_bytes")}


def _load_golden():
    return json.loads((_GOLDEN_DIR / "histories.json").read_text())


def _weights0():
    with jax.threefry_partitionable(False):
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    return {k: np.asarray(v) for k, v in w.items()}


@pytest.fixture(scope="module")
def golden():
    return _load_golden()


@pytest.fixture(scope="module")
def weights0():
    return _weights0()


def _value(rec, key):
    v = rec[key]
    return float.fromhex(v) if isinstance(v, str) else v


def _port_history(tname, mname, weights0):
    setup = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                       weights0=weights0, device="cpu")
    h = run_fl(setup, epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
               **_gen.MODES[mname], **TRANSPORTS[tname])
    return _gen.history_record(h)


@pytest.mark.parametrize("tname,mname", CASES,
                         ids=[f"{t}-{m}" for t, m in CASES])
def test_port_history_matches_golden(tname, mname, golden, weights0):
    got = _port_history(tname, mname, weights0)
    want = golden[f"{tname}/{mname}"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in EXACT[tname]:
            assert _value(g, key) == _value(w, key), key
        for key in WITHIN_2PCT[tname]:
            assert abs(_value(g, key) - _value(w, key)) \
                <= 0.02 * abs(_value(w, key)), key
        assert abs(_value(g, "accuracy") - _value(w, "accuracy")) \
            <= ACC_TOL


if __name__ == "__main__":
    gold, w0 = _load_golden(), _weights0()
    for tname, mname in CASES:
        got = _port_history(tname, mname, w0)
        want = gold[f"{tname}/{mname}"]

        def gap(key, rel=False):
            return max(abs(_value(g, key) - _value(w, key))
                       / (max(abs(_value(w, key)), 1e-300) if rel else 1)
                       for g, w in zip(got, want))
        print(f"{tname}/{mname}: accuracy gap {gap('accuracy') * 512:g}/512,"
              f" time {gap('time', True):.3g} rel,"
              f" up_bytes {gap('up_bytes', True):.3g} rel")
