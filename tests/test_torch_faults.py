"""The port's fault tools (``runtime/faults.py``) against the JAX
package's, and ``chip_smoke.py``'s controls of its fleet phase.

* ``FaultInjector`` (by worker and by population lane), ``ElasticPool``
  and ``TopologyFaultInjector`` schedules give the same histories as
  JAX's, every non-accuracy field exact, accuracy within 4/512
  (tests/test_torch_golden.py's bound; measured: 0 of 512); ``ChaosSchedule.apply`` samples
  the same events from the same seed over 1x1, 1x2 and 1x4 topologies.
* fl_figures.fig_chaos_sweep's smoke run (1x2, sync push, top-k+int8
  worker and server links, root killed after the first merge, 6 rounds,
  cut from 10 local epochs to 2)
  at loss 0 and 0.1, failover on and off: ``audit_chaos_run``'s
  failovers, retransmits, versions and uplink bytes equal JAX's; the
  downlink bytes within 1% (a top-k tie moves a fan-out's kept count by
  a few, tests/test_torch_golden.py's caveat); the same run over raw
  links equals JAX's statistics exactly.
* ``chip_smoke.py``'s fleet controls fail as they must: a sender that
  re-encodes each retransmitted copy fails the encode check, and each
  faulty tuner moves more of the edge tier's codecs than the limit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import TABLE_4_1 as JTABLE
from repro.core.experiment import build_experiment as jbuild
from repro.core import make_setup as jmake_setup
from repro.core import topology as jtop
from repro.core.worker import FLWorker as JWorker
from repro.runtime import faults as jfaults
from repro_torch.core import build_experiment, make_setup
from repro_torch.core import topology as ttop
from repro_torch.core.worker import FLWorker as TWorker
from repro_torch.runtime import faults as tfaults

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working (several times the wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setups(table=None, **kw):
    table = table or JTABLE["mnist_even"]
    js = jmake_setup(table, **{**SETUP_KW, **kw})
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    return js, make_setup(table, **{**SETUP_KW, **kw}, weights0=w0,
                          device="cpu")


def _assert_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def _elastic_run(build, faults, worker_cls, setup, mode):
    loop, server = build(setup, mode=mode, selector="all",
                         epochs_per_round=2, max_rounds=4, transport="raw")
    inj = faults.FaultInjector(loop, server)
    inj.kill_at(0.2, "w3")
    inj.recover_at(0.9, "w3")
    inj.kill_lane_at(0.3, server.population.lane("w5"))
    inj.recover_lane_at(1.5, server.population.lane("w5"))
    pool = faults.ElasticPool(loop, server)
    pool.leave_at(0.4, "w7")
    prof = setup.profiles[7]
    shard = (setup.device_shards if hasattr(setup, "device_shards")
             else setup.shards)[7]
    pool.join_at(1.0, worker_cls(
        "w7", profile=prof, data=shard, train_fn=setup.train_fn, loop=loop,
        per_batch_time=setup.per_batch_server * 3.0 /
        max(prof.cpu_freq * prof.cpu_prop, 1e-9)))
    server.start()
    loop.run()
    return server.history


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_fault_injector_and_elastic_pool_replay_jax(mode):
    js, ts = _setups()
    _assert_match(_elastic_run(jbuild, jfaults, JWorker, js, mode),
                  _elastic_run(build_experiment, tfaults, TWorker, ts, mode))


@pytest.mark.parametrize("topo", ["1x1", "1x2", "1x4"])
def test_chaos_schedule_samples_jax_events(topo):
    js, ts = _setups()
    for seed in (0, 5, 123):
        kw = dict(seed=seed, horizon=2.0, n_worker_kills=3,
                  n_leaf_kills=2, kill_root=True)
        _, jt = jtop.build_topology(js, topology=jtop.parse_topology(topo))
        _, tt = ttop.build_topology(ts, topology=ttop.parse_topology(topo))
        je = jfaults.ChaosSchedule(**kw).apply(jt)
        te = tfaults.ChaosSchedule(**kw).apply(tt)
        assert te == je and te
        for lid, lf in tt.leaves.items():
            rel, jrel = lf.server.transport.reliability, \
                jt.leaves[lid].server.transport.reliability
            assert vars(rel) == vars(jrel)
            assert lf.server.transport.rel_estimator is lf.server.est


def _smoke(top, faults, setup, drop_p, failover, codec):
    """fig_chaos_sweep's smoke run of one (loss, failover) cell."""
    sched = faults.ChaosSchedule(seed=123, drop_p=drop_p, dup_p=drop_p / 2,
                                 n_worker_kills=0)

    def on_build(topo):
        sched.apply(topo)
        merge = topo._merge

        def merge_then_kill():
            merge()
            if topo.version == 1 and not topo.done:
                topo.loop.schedule(1e-3, topo.kill_root)
        topo._merge = merge_then_kill
    res = top.run_fl_topology(
        setup, topology=top.parse_topology(
            "1x2", push="sync", server_codec=codec, server_frac=0.1,
            server_bandwidth=200e6 / 40, root_failover=failover),
        mode="sync", selector="all", epochs_per_round=2, max_rounds=6,
        transport=codec, transport_frac=0.1, on_build=on_build)
    return faults.audit_chaos_run(res.topology)


@pytest.mark.parametrize("failover", [True, False],
                         ids=["failover_on", "failover_off"])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_chaos_smoke_audit_matches_jax(drop_p, failover):
    js, ts = _setups([1] * 12, noise=0.2, batch_size=64)
    sj = _smoke(jtop, jfaults, js, drop_p, failover, "topk_ef+int8")
    st = _smoke(ttop, tfaults, ts, drop_p, failover, "topk_ef+int8")
    for k in ("failovers", "retransmits", "root_versions", "leaf_versions",
              "total_up_bytes"):
        assert st[k] == sj[k], k
    assert abs(st["total_down_bytes"] - sj["total_down_bytes"]) \
        <= 0.01 * sj["total_down_bytes"]
    assert st["failovers"] == int(failover)


def test_chaos_smoke_over_raw_links_matches_jax_exactly():
    js, ts = _setups([1] * 12, noise=0.2, batch_size=64)
    sj = _smoke(jtop, jfaults, js, 0.1, True, "raw")
    st = _smoke(ttop, tfaults, ts, 0.1, True, "raw")
    assert st == sj and st["retransmits"] > 0


def _fleet_setup(key):
    return chip_smoke.fleet_setup(key, "cpu", {})


def test_chip_smoke_reencode_control_fails_the_encode_check():
    key = "lossy/uplink_only"
    with chip_smoke.counted_encodes() as calls:
        _, extra = chip_smoke.fleet_call(key, _fleet_setup(key), 2)
    chip_smoke.check_encodes(calls[0], extra["ledger"], extra["retx_up"],
                             key)
    with chip_smoke.reencode_on_retransmit(), \
            chip_smoke.counted_encodes() as calls:
        _, extra = chip_smoke.fleet_call(key, _fleet_setup(key), 2)
    with pytest.raises(AssertionError, match="logical uplink payloads"):
        chip_smoke.check_encodes(calls[0], extra["ledger"],
                                 extra["retx_up"], key)


@pytest.mark.parametrize("fault", chip_smoke.AUTO_FAULTS)
def test_chip_smoke_tuner_controls_exceed_the_codec_limit(fault):
    key = f"auto/{chip_smoke.AUTO_FAULT_TIER}"
    with chip_smoke.recorded_codecs() as right:
        chip_smoke.fleet_call(key, _fleet_setup(key), 4)
    with chip_smoke.faulty_tuner(fault), \
            chip_smoke.recorded_codecs() as wrong:
        chip_smoke.fleet_call(key, _fleet_setup(key), 4)
    assert chip_smoke.codec_gap(right, right) == 0.0
    assert chip_smoke.codec_gap(wrong, right) > chip_smoke.AUTO_CODEC_GAP
