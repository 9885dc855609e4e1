"""The port keeps its own copies of the pure-Python control plane (events,
estimator, population, selection, warehouse).  Each scenario below drives
one module of either package with the same call sequence and records
what it returns; the two records must be identical."""
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.core.{name}")
            for name in ("events", "estimator", "population", "selection",
                         "warehouse")}


def _profiles(est_mod, n=9):
    return [est_mod.WorkerProfile(worker_id=f"w{i}",
                                  cpu_freq=[3.0, 2.0, 1.0][i % 3],
                                  cpu_prop=[1.0, 0.9, 0.8][i % 3],
                                  bandwidth=[200e6, 80e6, 30e6][i % 3],
                                  n_batches=1 + i % 2)
            for i in range(n)]


def scenario_events(m):
    loop = m["events"].EventLoop()
    out = []
    loop.schedule(0.5, out.append, "b")
    ev = loop.schedule(0.2, out.append, "cancelled")
    loop.schedule(0.2, out.append, "a")
    loop.cancel(ev)
    loop.schedule_abs(0.9, lambda: loop.schedule(0.1, out.append, "d"))
    loop.call_soon(out.append, "first")
    loop.run(max_events=3)
    out.append(("paused", loop.now, loop.exhausted))
    loop.run()
    out.append(("done", loop.now, loop.exhausted, loop.events_run))
    return out


def scenario_estimator(m):
    est = m["estimator"].TimeEstimator(server_freq=3.0, t_onebatch_server=0.05)
    ps = _profiles(m["estimator"])
    out = [(est.t_one(p), est.t_transmit(p, 136744)) for p in ps]
    est.observe_training("w1", 0.37)
    est.observe_transmit("w1", 0.002, 136744)
    est.observe_transmit("w4", 0.01, 20000)
    out.append([(est.t_one(p), est.t_transmit(p, 50000)) for p in ps])
    out.append((est.bandwidth("w1"), est.bandwidth("w0"),
                est.median_bandwidth()))
    return out


def scenario_population(m):
    pop = m["population"].WorkerPopulation()
    est = m["estimator"].TimeEstimator()
    est.bind_population(pop)
    ps = _profiles(m["estimator"])
    lanes = [pop.adopt(p) for p in ps]
    est.observe_training("w2", 0.5)
    est.observe_transmit("w3", 0.1, 1000)
    ps[5].failed = True
    pop.note_response("w6", 3, 2)
    pop.release("w7")
    view = pop.view_for([p.worker_id for p in ps[:7]])
    return [lanes, len(pop), view.worker_ids(), view.alive_mask().tolist(),
            view.ids_where(view.alive_mask()),
            est.t_one_vec(view).tolist(),
            est.t_transmit_vec(view, 4096).tolist(),
            pop.staleness[:len(pop)].tolist()]


def scenario_selection(m):
    est = m["estimator"].TimeEstimator()
    pop = m["population"].WorkerPopulation()
    est.bind_population(pop)
    ps = _profiles(m["estimator"])
    for p in ps:
        pop.adopt(p)
    view = pop.view_for([p.worker_id for p in ps])
    out = []
    for kind, kw in (("all", {}), ("random", {"k": 4, "seed": 1}),
                     ("rmin_rmax", {"rmin": 2.0, "rmax": 3.0}),
                     ("time_based", {"r": 3, "T0": 0.0, "A": 0.01})):
        sel = m["selection"].make_selector(kind, est, lambda: 136744, **kw)
        for acc in (0.1, 0.105, 0.3, 0.301, 0.5):
            out.append((kind, list(sel.select(view)), list(sel.select(ps))))
            sel.on_round_end(acc)
    return out


def scenario_warehouse(m):
    wh = m["warehouse"].DataWarehouse()
    uid = wh.put({"w": np.arange(3)})
    t1 = wh.issue_ticket(uid)
    uid2 = wh.put("payload", uid="fixed")
    t2 = wh.issue_ticket(uid2)
    out = [uid, uid2, uid in wh, wh.has_ticket(t1),
           wh.redeem_ticket(t1)["w"].tolist(), uid in wh, wh.has_ticket(t1)]
    wh.revoke_ticket(t2)
    out += ["fixed" in wh, wh.has_ticket(t2)]
    with pytest.raises(KeyError):
        wh.redeem_ticket(t1)
    p = m["warehouse"].Pointer("server://a", "obj0")
    return out + [str(p)]


SCENARIOS = {f.__name__[len("scenario_"):]: f
             for f in (scenario_events, scenario_estimator,
                       scenario_population, scenario_selection,
                       scenario_warehouse)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_plane_copy_behaves_identically(name):
    ref, port = (SCENARIOS[name](_mods(pkg)) for pkg in PACKAGES)
    assert port == ref
