"""The port's hierarchical topology (``core/topology.py`` and the server's
leaf role) against the golden fixtures and the JAX package.

* The ``raw_flat1x1`` aliases of ``TOPOLOGY_ALIASES`` match the ``raw/*``
  fixtures as tests/test_torch_golden.py holds them (every non-accuracy
  field exact, accuracy within 4 of 512 test samples) and equal the
  port's single-server run bit for bit.
* 1x2 and 1x4, sync and async push, sync and async leaves: the root's
  and every leaf's history equal JAX's in every non-accuracy field,
  accuracy within 4/512 (measured: 0 of 512 at every point of every
  case, the kills' too).
* ``kill_leaf`` (with its workers re-attached to a survivor) and
  ``kill_root`` with failover: histories, the failover's first
  dispatches and ``audit_chaos_run``'s statistics equal JAX's.
* ``install_global`` drops a leaf's packed mirror and its server
  optimizer's ``prev`` anchor, which a merge may have consumed; the next
  merge is the one a fresh state makes from the installed model.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import TABLE_4_1 as JTABLE
from repro.core import make_setup as jmake_setup
from repro.core import topology as jtop
from repro.runtime import faults as jfaults
from repro_torch.core import TABLE_4_1, build_experiment, make_setup, run_fl
from repro_torch.core import flatbuf
from repro_torch.core import topology as ttop
from repro_torch.runtime import faults as tfaults

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")
EXACT = ("time", "version", "n_updates", "selected", "up_bytes",
         "down_bytes")
MODES = {"sync": dict(mode="sync", selector="all"),
         "async": dict(mode="async", selector="all", async_alpha=0.9,
                       async_latest_table=False, aggregator="linear")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working (several times the wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(rec, key):
    v = rec[key]
    return float.fromhex(v) if isinstance(v, str) else v


@pytest.fixture(scope="module")
def golden_weights0():
    import jax
    from repro.models.mlp import init_mlp
    with jax.threefry_partitionable(False):
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    return {k: np.asarray(v) for k, v in w.items()}


@pytest.mark.parametrize("mode", sorted(_gen.MODES))
def test_flat1x1_alias_matches_the_raw_fixture(mode, golden_weights0):
    prefix, kw = _gen.TOPOLOGY_ALIASES["raw_flat1x1"]
    want = json.loads((_GOLDEN_DIR / "histories.json").read_text())[
        f"{prefix}/{mode}"]
    runs = {}
    for name, tkw in (("1x1", kw), ("single", dict(transport="raw"))):
        setup = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                           weights0=golden_weights0, device="cpu")
        runs[name] = run_fl(setup, epochs_per_round=_gen.EP,
                            max_rounds=_gen.ROUNDS, **_gen.MODES[mode],
                            **tkw)
    got = _gen.history_record(runs["1x1"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in EXACT:
            assert _value(g, key) == _value(w, key), key
        assert abs(_value(g, "accuracy") - _value(w, "accuracy")) <= ACC_TOL
    assert [vars(p) for p in runs["1x1"]] == \
        [vars(p) for p in runs["single"]]


def _setups():
    js = jmake_setup(JTABLE["mnist_even"], **_gen.SETUP_KW)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    return js, make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                          weights0=w0, device="cpu")


def _assert_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def _assert_results_match(rj, rt):
    _assert_match(rj.root_history, rt.root_history)
    assert sorted(rj.leaf_histories) == sorted(rt.leaf_histories)
    for lid in rj.leaf_histories:
        _assert_match(rj.leaf_histories[lid], rt.leaf_histories[lid])


CASES = [(t, p, m) for t in ("1x2", "1x4") for p in ("sync", "async")
         for m in sorted(MODES)]


@pytest.mark.parametrize("topo,push,mode", CASES,
                         ids=[f"{t}-{p}push-{m}" for t, p, m in CASES])
def test_topology_matches_jax(topo, push, mode):
    js, ts = _setups()
    kw = dict(epochs_per_round=2, max_rounds=3, transport="raw",
              **MODES[mode])
    rj = jtop.run_fl_topology(js, topology=jtop.parse_topology(
        topo, push=push), **kw)
    rt = ttop.run_fl_topology(ts, topology=ttop.parse_topology(
        topo, push=push), **kw)
    _assert_results_match(rj, rt)
    assert rt.root_history[-1].version > 0
    assert rt.root_history[-1].down_bytes == rt.topology.total_down_bytes


def _faulted(top, faults, setup, push, kill):
    def on_build(topo):
        if kill == "leaf":
            inj = faults.TopologyFaultInjector(topo)
            inj.kill_leaf_at(0.5, "leaf1")
            inj.reattach_workers_at(0.6, "leaf1", "leaf0")
        else:
            merge = topo._merge

            def merge_then_kill():
                merge()
                if topo.version == 1 and not topo.done:
                    topo.loop.schedule(1e-3, topo.kill_root)
            topo._merge = merge_then_kill
    res = top.run_fl_topology(
        setup, topology=top.parse_topology("1x3", push=push,
                                           server_codec="delta"),
        mode="sync", selector="all", epochs_per_round=2, max_rounds=4,
        transport="raw", on_build=on_build)
    return res, faults.audit_chaos_run(res.topology)


@pytest.mark.parametrize("kill", ["leaf", "root"])
@pytest.mark.parametrize("push", ["sync", "async"])
def test_kills_and_failover_match_jax(kill, push):
    js, ts = _setups()
    rj, sj = _faulted(jtop, jfaults, js, push, kill)
    rt, st = _faulted(ttop, tfaults, ts, push, kill)
    _assert_results_match(rj, rt)
    assert st == sj
    assert rt.topology.failover_dispatches == rj.topology.failover_dispatches
    if kill == "root":
        assert st["failovers"] == 1
        # delta, not raw, re-provisioning after the failover
        assert all(codec == "delta" for _, codec, had in
                   rt.topology.failover_dispatches if had)
    else:
        assert rt.topology.leaves["leaf1"].dead
        assert "w1" in rt.topology.leaves["leaf0"].server.workers


def test_install_global_drops_a_consumed_prev():
    """A FedAsync leaf with a server optimizer: its alpha < 1 merges write
    the packed mirror in place and take it as ``prev``.  After an install
    neither the mirror nor the anchor survives, and the next merge equals
    a fresh state's from the installed model."""
    setup = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                       device="cpu")
    kw = dict(epochs_per_round=1, max_rounds=2, server_opt="fedavgm",
              server_opt_kw={"momentum": 0.9}, **MODES["async"])
    _, server = build_experiment(setup, **kw)
    loop = server.loop
    server.start()
    loop.run()
    assert server._flat._server_flat is not None
    installed = {k: v + 0.01 for k, v in setup.weights0.items()}
    server.install_global(installed)
    assert server._flat._server_flat is None
    assert server.server_opt._prev_vec is None
    assert server.weights is installed
    # the next merge against a twin that never held the old model, with
    # the same momentum
    twin = flatbuf.FlatServerState(installed)
    twin.server_opt = type(server.server_opt)(momentum=0.9)
    twin.server_opt._m = server.server_opt._m.clone()
    rows = [flatbuf.ParamBundle(installed).pack(
        {k: v * 0.5 for k, v in installed.items()})]
    got = server._flat.merge_rows(installed, rows, [1.0], 0.9)
    want = twin.merge_rows(installed, rows, [1.0], 0.9)
    assert all(torch.equal(got[k], want[k]) for k in got)
