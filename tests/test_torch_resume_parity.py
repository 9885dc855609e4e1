"""Checkpoints of the port against the JAX package's, on the CPU.

The same numpy initial weights go into ``repro`` and ``repro_torch``;
each side runs with ``checkpoint_every=1`` and stops after its first
snapshot.  The two snapshots agree exactly on the server's ``version``,
``round_id`` and byte counters, on every non-accuracy field of the
history (accuracy within 4/512, tests/test_torch_golden.py's bound), on
the population lanes (NaN where a worker has no measurement yet) and on
the pending events' sorted ``(time, seq, kind)`` records: the port's
worker, server and topology consume event sequence numbers as JAX's do,
so its resume replays the same order.  Then each side's resumed run
equals its own uninterrupted run in every field (floats as
``float.hex``), and the port's resumed run equals JAX's uninterrupted
one in every non-accuracy field.

The reference's own split tests against the golden fixtures
(tests/test_golden_histories.py) are not used as the oracle: under this
JAX version they can fail at version 0, before any checkpoint, because
the initial weights differ from the fixtures' (ROADMAP C).
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import TABLE_4_1 as JTABLE
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.core import topology as jtop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import TABLE_4_1, make_setup, run_fl
from repro_torch.core import topology as ttop

SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
EP, ROUNDS = 2, 3
ACC_TOL = 4 / 512
MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
    "async_delta": dict(mode="async", selector="all", async_delta=True),
    "time_based": dict(mode="sync", selector="time_based",
                       selector_kw={"r": EP, "T0": 0.0, "A": 0.01}),
}
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setups():
    js = jmake_setup(JTABLE["mnist_even"], **SETUP_KW)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    return js, make_setup(TABLE_4_1["mnist_even"], **SETUP_KW, weights0=w0,
                          device="cpu")


def _rec(history):
    return [(p.time.hex(), p.version, float(p.accuracy).hex(), p.n_updates,
             p.selected, p.up_bytes, p.down_bytes, p.retransmits)
            for p in history]


def _assert_histories_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def _events(snap):
    return sorted((r["t"], r["seq"], r["kind"]) for r in snap.events)


def _assert_server_images_match(a, b):
    for k in ("version", "round_id", "round_open", "timeout_rid",
              "total_up", "total_down", "outstanding", "inflight_w"):
        assert a[k] == b[k], k
    _assert_histories_match(a["history"], b["history"])
    pa, pb = a["population"], b["population"]
    assert pa["size"] == pb["size"]
    assert sorted(pa["lanes"]) == sorted(pb["lanes"])
    for name, lane in pa["lanes"].items():
        assert np.array_equal(lane, pb["lanes"][name], equal_nan=True), name
    assert sorted(a["transport"]["links"]) == sorted(b["transport"]["links"])


def _first_snapshots(mname, tmp_path, push=None):
    """Each side's first snapshot of a single-server run, or of a 1x2
    topology with ``push``."""
    js, ts = _setups()
    kw = dict(epochs_per_round=EP, max_rounds=ROUNDS, transport="raw",
              **MODES[mname], checkpoint_every=1, stop_after_checkpoints=1)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    if push is None:
        jrun_fl(js, checkpoint_dir=dj, **kw)
        run_fl(ts, checkpoint_dir=dt, **kw)
    else:
        jtop.run_fl_topology(js, topology=jtop.parse_topology(
            "1x2", push=push), checkpoint_dir=dj, **kw)
        ttop.run_fl_topology(ts, topology=ttop.parse_topology(
            "1x2", push=push), checkpoint_dir=dt, **kw)
    sj_step, sj, _ = JManager(dj).restore_latest()
    st_step, st, _ = CheckpointManager(dt).restore_latest()
    assert sj_step == st_step
    return sj, st


@pytest.mark.parametrize("mname", sorted(MODES))
def test_first_snapshot_agrees_with_jax(mname, tmp_path):
    sj, st = _first_snapshots(mname, tmp_path)
    assert sj.kind == st.kind == "run"
    assert sj.clock == st.clock
    _assert_server_images_match(sj.state["server"], st.state["server"])
    assert _events(sj) == _events(st)
    assert st.events and sj.rekicks == st.rekicks == []
    # the worker legs carry the same phases at the same deadlines
    assert sorted((r["t"], r["seq"], r["rec"]["phase"]) for r in sj.events
                  if r["kind"] == "worker_leg") == \
        sorted((r["t"], r["seq"], r["rec"]["phase"]) for r in st.events
               if r["kind"] == "worker_leg")


@pytest.mark.parametrize("push", ["sync", "async"])
def test_first_topology_snapshot_agrees_with_jax(push, tmp_path):
    """1x2 over raw links: the root's version, counters and history, each
    leaf server's image, and the pending (time, seq, kind) records (leaf
    pushes, fan-outs, settles and worker legs)."""
    sj, st = _first_snapshots("sync", tmp_path, push=push)
    for k in ("version", "total_up", "total_down", "done"):
        assert sj.state[k] == st.state[k], k
    _assert_histories_match(sj.state["history"], st.state["history"])
    assert sorted(sj.state["servers"]) == sorted(st.state["servers"])
    for lid in sj.state["servers"]:
        _assert_server_images_match(sj.state["servers"][lid],
                                    st.state["servers"][lid])
    assert _events(sj) == _events(st)


@pytest.mark.parametrize("mname", sorted(MODES))
def test_each_side_resumes_to_its_own_uninterrupted_run(mname, tmp_path):
    kw = dict(epochs_per_round=EP, max_rounds=ROUNDS, transport="raw",
              **MODES[mname])
    js, ts = _setups()
    full_j = jrun_fl(js, **kw)
    full_t = run_fl(ts, **kw)
    for fn, setup, d in ((jrun_fl, js, tmp_path / "jax"),
                         (run_fl, ts, tmp_path / "torch")):
        fn(setup, **kw, checkpoint_every=1, checkpoint_dir=str(d),
           stop_after_checkpoints=1)
    res_j = jrun_fl(js, **kw, checkpoint_dir=str(tmp_path / "jax"),
                    resume=True)
    res_t = run_fl(ts, **kw, checkpoint_dir=str(tmp_path / "torch"),
                   resume=True)
    assert _rec(res_j) == _rec(full_j)
    assert _rec(res_t) == _rec(full_t)
    _assert_histories_match(full_j, res_t)
