"""``benchmarks/torch_fl_figures.py`` against ``benchmarks/fl_figures.py``,
on the CPU.

* The wiring of each figure and table function (figures 4.1-4.7, table
  5.1, the 30-worker figure): ``make_setup``, ``run_fl`` and
  ``run_sequential_baseline`` are replaced in both modules by recorders
  that return canned histories.  The twin makes the reference's calls
  with the reference's arguments (its own ``weights0`` and ``device``
  aside: each setup gets the fixture's weights for its input width),
  returns the same ``derived`` dict and writes the same files.
* Each sweep's ``smoke=True`` form, twin (from the fixture's weights)
  against reference (under ``jax.threefry_partitionable(False)``), with
  both modules' result paths moved to ``tmp_path``: the configs, the
  codec every link resolves at every encode (counted), versions, audit
  numbers and the resume's bit-identical stitch exactly; times and wire
  bytes exactly, except on runs whose downlink or server links are top-k
  (dlink's symmetric runs, the multi-leaf topologies, every chaos and
  resume run), where a tie at the threshold moves a fan-out's kept count
  by a few bytes (ROADMAP C, "Symmetric top-k links are statistical"):
  there within ``REL`` (measured: at most 2.6e-4, chaos's downlink);
  each t80 within half a history step of the reference's at its crossing
  (measured: at most 0.75 s, autotune's top-k run, between points ~2.4 s
  apart); snapshot sizes within 1% (pickles of different objects).
  Accuracy itself is not compared: it is chaotic (ROADMAP C).
* The twin writes under ``benchmarks/results/torch``, never over a
  reference result file.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

import repro.core.transport as jtr
import repro_torch.core.transport as ttr

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-3
TARGET = 0.8
FIGURES = ("fig4_1_sequential_vs_fl", "fig4_2_even_vs_uneven",
           "fig4_3_random_vs_sequential", "fig4_4_rminrmax_vs_sequential",
           "fig4_5_rminrmax_initialisation", "fig4_6_alg2_sync",
           "fig4_7_alg2_async", "table5_1_time_to_accuracy",
           "fig_30workers")
SWEEPS = ("fig_dlink_bandwidth_sweep", "fig_topology_sweep",
          "fig_chaos_sweep", "fig_autotune_sweep", "fig_resume_sweep",
          "fig_heterogeneity_sweep")
# runs whose downlink or server links are top-k
STATISTICAL = {
    "fig_dlink_bandwidth_sweep": lambda name: name.endswith("/symmetric"),
    "fig_topology_sweep": lambda name: not name.endswith("/leaves1"),
    "fig_chaos_sweep": lambda name: True,
    "fig_resume_sweep": lambda name: True,
}
ALWAYS_EXACT = ("root_versions", "failovers", "retransmits",
                "rounds_before_kill", "rounds_total", "t80_parity")
T80_KEYS = ("t80", "t80_uninterrupted", "t80_resumed")
NOT_COMPARED = ("final_accuracy", "wall_s", "checkpoint_bytes",
                "checkpoint_mib")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def modules():
    return _load("fl_figures"), _load("torch_fl_figures")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module runs torch on one CPU thread: beside other test
    processes torch's thread pool spins instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redirect(monkeypatch, mod, root):
    monkeypatch.setattr(mod, "RESULTS", root / "figures")
    monkeypatch.setattr(mod, "BENCH_RESULTS", root)


class Recorder:
    """Stands in for ``make_setup``, ``run_fl`` and
    ``run_sequential_baseline``: records each call and returns canned
    histories that depend only on the call's index."""

    def __init__(self):
        self.calls, self.weights0, self.n_setups = [], [], 0

    def make_setup(self, batches, **kw):
        self.weights0.append(kw.pop("weights0", "none given"))
        kw.pop("device", None)
        if "cfg" in kw:
            kw["cfg"] = dataclasses.asdict(kw["cfg"])
        self.calls.append(("make_setup", list(batches), kw))
        setup = SimpleNamespace(
            index=self.n_setups,
            profiles=[SimpleNamespace(bandwidth=1e8) for _ in batches])
        self.n_setups += 1
        return setup

    def _history(self):
        c = len(self.calls)
        return [SimpleNamespace(time=i * (1.0 + 0.1 * c), version=i,
                                accuracy=min(0.99, 0.09 * i + 0.01 * c),
                                n_updates=1, selected=1, up_bytes=0,
                                down_bytes=0, retransmits=0)
                for i in range(14)]

    def run_fl(self, setup, **kw):
        self.calls.append(("run_fl", setup.index, kw))
        return self._history()

    def run_sequential_baseline(self, setup, **kw):
        self.calls.append(("run_sequential_baseline", setup.index, kw))
        return self._history()


@pytest.mark.parametrize("name", FIGURES)
def test_twin_makes_the_references_calls(name, modules, monkeypatch,
                                         tmp_path):
    ref, twin = modules
    recs = {}
    for side, mod in (("ref", ref), ("twin", twin)):
        rec = recs[side] = Recorder()
        for fn in ("make_setup", "run_fl", "run_sequential_baseline"):
            monkeypatch.setattr(mod, fn, getattr(rec, fn))
        _redirect(monkeypatch, mod, tmp_path / side)
    weights0 = twin.load_weights0()
    want = ref.ALL[name]()
    got = twin.ALL[name](weights0=weights0, device="cpu")
    assert recs["twin"].calls == recs["ref"].calls
    assert got == want
    assert set(recs["ref"].weights0) == {"none given"}
    setups = [c for c in recs["twin"].calls if c[0] == "make_setup"]
    for (_, _, kw), w in zip(setups, recs["twin"].weights0):
        cfg = kw.get("cfg", {"image_hw": 16, "channels": 1})
        assert w is weights0[cfg["image_hw"] ** 2 * cfg["channels"]]
    files = {side: {p.relative_to(tmp_path / side): json.loads(p.read_text())
                    for p in (tmp_path / side).rglob("*.json")}
             for side in recs}
    assert files["twin"] == files["ref"] and files["ref"]


def _counting(mod, monkeypatch):
    counts = {"up": {}, "down": {}}
    for d in counts:
        real = getattr(mod.Transport, f"resolve_{d}")

        def resolve(self, link, _real=real, _d=d):
            spec, frac = _real(self, link)
            counts[_d][spec.name] = counts[_d].get(spec.name, 0) + 1
            return spec, frac
        monkeypatch.setattr(mod.Transport, f"resolve_{d}", resolve)
    return counts


def _close(got, want, statistical):
    if not statistical or isinstance(want, bool):
        return got == want
    if isinstance(want, (int, float)) and isinstance(got, (int, float)):
        return abs(got - want) <= REL * max(abs(want), 1)
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _close(got[k], want[k], statistical) for k in want)
    return got == want


def t80_limit(curve):
    """Half a history step of a curve ((time, accuracy, ...) points) at
    its crossing of the target."""
    i = next(i for i, p in enumerate(curve) if p[1] >= TARGET)
    prev = max(p[0] for p in curve[:i] if p[0] < curve[i][0])
    return 0.5 * (curve[i][0] - prev)


@pytest.fixture(scope="module")
def sweep_records(modules, tmp_path_factory):
    """Each sweep's smoke form on both sides: {name: (records, codec
    counts, returned summaries)}, twin's and reference's."""
    ref, twin = modules
    weights0 = twin.load_weights0()
    out = {}
    for name in SWEEPS:
        root = tmp_path_factory.mktemp(name)
        mp = pytest.MonkeyPatch()
        try:
            recs = {}
            for side, mod, counted in (("ref", ref, jtr),
                                       ("twin", twin, ttr)):
                _redirect(mp, mod, root / side)
                counts = _counting(counted, mp)
                if side == "ref":
                    with jax.threefry_partitionable(False):
                        summary = mod.ALL[name](smoke=True)
                else:
                    summary = mod.ALL[name](smoke=True, weights0=weights0,
                                            device="cpu")
                (bench,) = (root / side).glob("BENCH_*.json")
                recs[side] = (json.loads(bench.read_text()), counts,
                              summary, bench.name)
        finally:
            mp.undo()
        out[name] = recs
    return out


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_smoke_matches_the_reference(name, sweep_records):
    got, got_codecs, got_summary, got_file = sweep_records[name]["twin"]
    want, want_codecs, want_summary, want_file = sweep_records[name]["ref"]
    assert got_file == want_file
    assert got["config"] == want["config"]
    assert got_codecs == want_codecs
    assert sum(want_codecs["up"].values()) > 0 or name == "fig_resume_sweep"
    assert got_summary.keys() == want_summary.keys()
    statistical = STATISTICAL.get(name, lambda run: False)
    assert got["curves"].keys() == want["curves"].keys()
    for run, curve in want["curves"].items():
        mine = got["curves"][run]
        assert len(mine) == len(curve), run
        for i, (g, w) in enumerate(zip(mine, curve)):
            cols = [j for j in range(len(w)) if j != 1]     # not accuracy
            assert all(_close(g[j], w[j], statistical(run)) for j in cols), \
                (run, i, g, w)
    assert got["derived"].keys() == want["derived"].keys()
    for run, rec in want["derived"].items():
        if run.endswith("summary") or run not in want["curves"]:
            continue
        mine = got["derived"][run]
        assert mine.keys() == rec.keys()
        for key, w in rec.items():
            g = mine[key]
            if key in NOT_COMPARED:
                continue
            if key in T80_KEYS:
                if w is None:
                    assert g is None, (run, key)
                else:
                    assert abs(g - w) <= t80_limit(want["curves"][run]), \
                        (run, key, g, w)
            elif key in ALWAYS_EXACT:
                assert g == w, (run, key)
            else:
                assert _close(g, w, statistical(run)), (run, key, g, w)
    if name == "fig_resume_sweep":
        for run, rec in want["derived"].items():
            mine = got["derived"][run]
            assert mine["t80_parity"] and rec["t80_parity"]
            assert len(mine["checkpoint_bytes"]) == \
                len(rec["checkpoint_bytes"])
            for g, w in zip(mine["checkpoint_bytes"],
                            rec["checkpoint_bytes"]):
                assert abs(g - w) <= 0.01 * w


def test_twin_results_go_under_results_torch(modules):
    ref, twin = modules
    assert twin.RESULTS != ref.RESULTS
    assert twin.BENCH_RESULTS != ref.BENCH_RESULTS
    assert twin.BENCH_RESULTS.relative_to(ROOT) == \
        Path("benchmarks/results/torch")


if __name__ == "__main__":
    # The reference's every function (full form) on the CPU under the
    # legacy PRNG, beside the twin's card results committed in
    # benchmarks/results/torch/figures_run.json:
    #     PYTHONPATH=src python tests/test_torch_figures.py OUT_DIR
    import sys
    out = Path(sys.argv[1])
    ref = _load("fl_figures")
    ref.RESULTS, ref.BENCH_RESULTS = out / "figures", out
    card = json.loads((ROOT / "benchmarks" / "results" / "torch" /
                       "figures_run.json").read_text())
    for name, fn in ref.ALL.items():
        with jax.threefry_partitionable(False):
            derived = fn()
        print(f"{name}\n  JAX, CPU: {json.dumps(derived, default=str)}\n"
              f"  port, card: "
              f"{json.dumps(card['figures'][name]['derived'])}", flush=True)
