"""The port's twin of ``benchmarks/fl_figures.py``: the thesis' figures
4.1-4.7, the §5.1.2 time-to-accuracy table (table 5.1), the 30-worker
figure and the six sweeps (downlink codecs, topology, chaos, auto codec,
resume, heterogeneity), in simulated time, through ``repro_torch``.

Same functions, constants, ``derived`` dicts and JSON shapes as the
reference.  Two keyword arguments are the twin's own:

* ``weights0``: the initial MLP weights by input width,
  ``{in_dim: {"w1": ..., "b1": ..., "w2": ..., "b2": ...}}`` (numpy
  arrays), handed to every ``make_setup``; :func:`load_weights0` reads
  the JAX package's ``init_mlp(PRNGKey(0))`` at the widths these setups
  use (256: 16x16x1; 768: 16x16x3) from ``tests/golden/
  jax_init_mlp_seed0.npz``.  None draws them from the port's own seeded
  generator.
* ``device``: where the runs go (``make_setup``'s ``device``; None is
  the CUDA card, and raises without one).

Curves land in ``benchmarks/results/torch/figures/<fig>.json`` and the
sweeps' records in ``benchmarks/results/torch/BENCH_*.json``, never over
the reference's files.

    PYTHONPATH=src python benchmarks/torch_fl_figures.py     # on the card
    PYTHONPATH=src python benchmarks/torch_fl_figures.py --device cpu \\
        --only table5_1_time_to_accuracy --results /tmp/figs
    PYTHONPATH=src python benchmarks/torch_fl_figures.py --smoke-dlink

Run from the command line, every run starts from the fixture's weights.
It runs on the card and exits when there is none, unless the CPU is asked
for (``--device cpu``).  The smoke flags (``--smoke-dlink``,
``--smoke-topology``, ``--smoke-chaos``, ``--smoke-scale``,
``--smoke-autotune``, ``--smoke-resume``, ``--smoke-hetero``) run one
sweep in its ``smoke=True`` form, as ``fl_figures.py`` and
``benchmarks/run.py`` dispatch them.  A run writes, besides the
figures, ``figures_run.json``: the card's name and power limit, and each
function's wall seconds and ``derived`` dict.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch import card_name, device_or_exit  # noqa: E402
from repro_torch.configs.paper_cnn import (FAST_CIFAR_CNN,  # noqa: E402
                                           FAST_MNIST_CNN)
from repro_torch.core import (TABLE_4_1, TABLE_4_2, make_setup,  # noqa: E402
                              run_fl, run_sequential_baseline,
                              time_to_accuracy)

RESULTS = Path(__file__).resolve().parent / "results" / "torch" / "figures"
BENCH_RESULTS = Path(__file__).resolve().parent / "results" / "torch"
WEIGHTS0_FILE = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                 / "jax_init_mlp_seed0.npz")

REGIME = dict(noise=0.2, batch_size=64, het="extreme")
EP = 10
ALG2 = {"r": EP, "T0": 0.0, "A": 0.01}
ASYNC_KW = dict(async_latest_table=False, async_alpha=0.9,
                async_stale_pow=0.25, aggregator="linear")


def load_weights0(path: Path = WEIGHTS0_FILE) -> dict:
    """``{in_dim: {name: array}}`` from the fixture, whose keys are
    ``in<in_dim>/<name>``."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            width, name = key.split("/")
            out.setdefault(int(width[2:]), {})[name] = z[key]
    return out


def _w0(weights0, cfg=FAST_MNIST_CNN):
    """The initial weights for an MLP on ``cfg``'s images, or None."""
    if weights0 is None:
        return None
    return weights0[cfg.image_hw * cfg.image_hw * cfg.channels]


def _dump(fig: str, curves: dict, derived: dict):
    RESULTS.mkdir(parents=True, exist_ok=True)
    payload = {
        "curves": {k: [(p.time, p.accuracy) for p in v]
                   for k, v in curves.items()},
        "derived": derived,
    }
    (RESULTS / f"{fig}.json").write_text(json.dumps(payload, indent=2))
    return derived


def fig4_1_sequential_vs_fl(*, weights0=None, device=None):
    """FL (even data, no selection) vs sequential: FL leads early,
    sequential reaches its plateau first (thesis finding 1)."""
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    fl = run_fl(setup, mode="sync", selector="all", epochs_per_round=EP,
                max_rounds=120)
    t60 = {"sequential": time_to_accuracy(seq, 0.6),
           "fl_even": time_to_accuracy(fl, 0.6)}
    return _dump("fig4_1", {"sequential": seq, "fl_even": fl},
                 {"t60": t60, "fl_leads_early": t60["fl_even"] < t60["sequential"]})


def fig4_2_even_vs_uneven(*, weights0=None, device=None):
    even = make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                      weights0=_w0(weights0), device=device)
    uneven = make_setup(TABLE_4_1["mnist_uneven"], seed=0, **REGIME,
                        weights0=_w0(weights0), device=device)
    h_even = run_fl(even, mode="sync", selector="all", epochs_per_round=EP,
                    max_rounds=120)
    h_uneven = run_fl(uneven, mode="sync", selector="all", epochs_per_round=EP,
                      max_rounds=120)
    d = {"t70_even": time_to_accuracy(h_even, 0.7),
         "t70_uneven": time_to_accuracy(h_uneven, 0.7)}
    return _dump("fig4_2", {"even": h_even, "uneven": h_uneven}, d)


def fig4_3_random_vs_sequential(*, weights0=None, device=None):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    rnd = run_fl(setup, mode="sync", selector="random", epochs_per_round=EP,
                 max_rounds=150, selector_kw={"k": 5, "seed": 1})
    d = {"t80_sequential": time_to_accuracy(seq, 0.8),
         "t80_random": time_to_accuracy(rnd, 0.8)}
    return _dump("fig4_3", {"sequential": seq, "random": rnd}, d)


HARD_REGIME = dict(noise=0.35, batch_size=64, het="extreme")
# ^ the thesis' model/data property (§4.2.4): any single tier's data is
#   insufficient for the target — required for the rmin/rmax stall (fig 4.5)


def fig4_4_rminrmax_vs_sequential(*, weights0=None, device=None):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **HARD_REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    rmm = run_fl(setup, mode="sync", selector="rmin_rmax", epochs_per_round=EP,
                 max_rounds=150, selector_kw={"rmin": 5.0, "rmax": 5.0})
    d = {"t80_sequential": time_to_accuracy(seq, 0.8),
         "t80_rminrmax": time_to_accuracy(rmm, 0.8),
         "final_rminrmax": rmm[-1].accuracy}
    return _dump("fig4_4", {"sequential": seq, "rmin_rmax": rmm}, d)


def fig4_5_rminrmax_initialisation(*, weights0=None, device=None):
    """Thesis fig 4.5: close rmin/rmax inits select too few workers and the
    eq-3.1/3.2 feedback can stall the run below its potential."""
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **HARD_REGIME,
                       weights0=_w0(weights0), device=device)
    curves, finals = {}, {}
    for rmax in (5.0, 7.0, 12.0):
        h = run_fl(setup, mode="sync", selector="rmin_rmax",
                   epochs_per_round=EP, max_rounds=120,
                   selector_kw={"rmin": 5.0, "rmax": rmax})
        curves[f"rmax={rmax}"] = h
        finals[f"rmax={rmax}"] = h[-1].accuracy
    return _dump("fig4_5", curves, {"finals": finals})


def fig4_6_alg2_sync(*, weights0=None, device=None):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    alg2 = run_fl(setup, mode="sync", selector="time_based",
                  epochs_per_round=EP, max_rounds=300, selector_kw=ALG2)
    s, y = time_to_accuracy(seq, 0.8), time_to_accuracy(alg2, 0.8)
    return _dump("fig4_6", {"sequential": seq, "alg2_sync": alg2},
                 {"t80_sequential": s, "t80_alg2_sync": y,
                  "improvement_pct": 100 * (1 - y / s)})


def fig4_7_alg2_async(*, weights0=None, device=None):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    sync = run_fl(setup, mode="sync", selector="time_based",
                  epochs_per_round=EP, max_rounds=300, selector_kw=ALG2)
    asyn = run_fl(setup, mode="async", selector="time_based",
                  epochs_per_round=EP, max_rounds=900, selector_kw=ALG2,
                  **ASYNC_KW)
    s = time_to_accuracy(seq, 0.8)
    y = time_to_accuracy(sync, 0.8)
    a = time_to_accuracy(asyn, 0.8)
    return _dump("fig4_7", {"sequential": seq, "alg2_sync": sync,
                            "alg2_async": asyn},
                 {"t80_sequential": s, "t80_sync": y, "t80_async": a,
                  "sync_vs_seq_pct": 100 * (1 - y / s),
                  "async_vs_sync_pct": 100 * (1 - a / y)})


def table5_1_time_to_accuracy(*, weights0=None, device=None):
    """§5.1.2 headline: MNIST-class + CIFAR-class time-to-target table
    (paper: sync+alg2 33.9%/59.0% faster than sequential; async a further
    63.3%/36.4%).  The CIFAR-class row is the MLP on 16x16x3 images, as
    the reference's (``cfg`` without ``model="cnn"``)."""
    rows = {}
    for task, kw, target in [
            ("mnist-class", dict(**REGIME), 0.8),
            ("cifar-class", dict(noise=1.0, batch_size=64, het="extreme",
                                 cfg=FAST_CIFAR_CNN, mlp_lr=0.03), 0.8)]:
        setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **kw,
                           weights0=_w0(weights0,
                                        kw.get("cfg", FAST_MNIST_CNN)),
                           device=device)
        seq = run_sequential_baseline(setup, epochs_per_round=EP,
                                      max_rounds=80)
        sync = run_fl(setup, mode="sync", selector="time_based",
                      epochs_per_round=EP, max_rounds=400, selector_kw=ALG2)
        asyn = run_fl(setup, mode="async", selector="time_based",
                      epochs_per_round=EP, max_rounds=1200, selector_kw=ALG2,
                      **ASYNC_KW)
        s = time_to_accuracy(seq, target)
        y = time_to_accuracy(sync, target)
        a = time_to_accuracy(asyn, target)
        rows[task] = {
            "target": target,
            "t_sequential": s, "t_sync_alg2": y, "t_async_alg2": a,
            "sync_vs_seq_pct": None if not (s and y) else 100 * (1 - y / s),
            "async_vs_sync_pct": None if not (y and a) else 100 * (1 - a / y),
        }
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "table5_1.json").write_text(json.dumps(rows, indent=2))
    return rows


def fig30_workers(*, weights0=None, device=None):
    """Thesis table 4.2 scale: 30 workers, even split."""
    setup = make_setup(TABLE_4_2["mnist_even"], seed=0, **REGIME,
                       weights0=_w0(weights0), device=device)
    seq = run_sequential_baseline(setup, epochs_per_round=EP, max_rounds=60)
    alg2 = run_fl(setup, mode="sync", selector="time_based",
                  epochs_per_round=EP, max_rounds=300, selector_kw=ALG2)
    s, y = time_to_accuracy(seq, 0.8), time_to_accuracy(alg2, 0.8)
    return _dump("fig_30workers", {"sequential": seq, "alg2_sync": alg2},
                 {"t80_sequential": s, "t80_alg2_sync": y,
                  "improvement_pct": None if not (s and y) else 100 * (1 - y / s)})


# --- downlink codec sweep ---------------------------------------------------

# bandwidth tiers: every profile's link divided by the tier factor — from
# "edge but usable" to "starved" to "last-mile modem", the asymmetric
# downlink-constrained regimes FLight and the fog-FL literature stress
DLINK_TIERS = {"edge/200": 200.0, "starved/1000": 1000.0,
               "modem/4000": 4000.0}
# codec'd direction combinations: raw both ways (the thesis), uplink-only
# compression, and the symmetric default
DLINK_MODES = {
    "raw": dict(transport="raw"),
    "uplink_only": dict(transport="topk_ef+int8", transport_down="raw",
                        transport_frac=0.1),
    "symmetric": dict(transport="topk_ef+int8", transport_frac=0.1),
}


def fig_dlink_bandwidth_sweep(smoke: bool = False, *, weights0=None,
                              device=None):
    """Bytes-to-accuracy: accuracy vs cumulative wire bytes (up + down)
    over 3 bandwidth tiers x {raw, uplink-only, symmetric} codecs.

    Emits ``BENCH_dlink.json``.  ``smoke=True`` runs a tiny 1-tier config
    that still exercises every codec combination and writes the same
    artifact shape.
    """
    tiers = ({"starved/1000": 1000.0} if smoke else DLINK_TIERS)
    max_rounds = 30 if smoke else 900
    target = None if smoke else 0.81
    curves, derived = {}, {}
    for tier, div in tiers.items():
        for mode, tkw in DLINK_MODES.items():
            setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.2,
                               batch_size=64, het="strong",
                               weights0=_w0(weights0), device=device)
            for p in setup.profiles:
                p.bandwidth /= div
            h = run_fl(setup, mode="async", selector="time_based",
                       aggregator="linear", epochs_per_round=EP,
                       max_rounds=max_rounds, selector_kw=ALG2,
                       async_latest_table=False, async_alpha=0.9,
                       async_stale_pow=0.25, target_accuracy=target, **tkw)
            name = f"{tier}/{mode}"
            curves[name] = [(p.time, p.accuracy, p.up_bytes, p.down_bytes)
                            for p in h]
            wire80 = next((p.up_bytes + p.down_bytes for p in h
                           if p.accuracy >= 0.8), None)
            # steady-state downlink cost: marginal bytes/dispatch past the
            # first-contact raw fallbacks (one per worker); None when the
            # run is too short to have a post-warmup window
            k = min(10, max(0, len(h) - 6))
            dv = h[-1].version - h[k].version
            marg = ((h[-1].down_bytes - h[k].down_bytes) / dv
                    if k >= 10 and dv > 0 else None)
            derived[name] = {
                "t80": time_to_accuracy(h, 0.8),
                "final_accuracy": h[-1].accuracy,
                "up_bytes": h[-1].up_bytes, "down_bytes": h[-1].down_bytes,
                "wire_bytes_to_80": wire80,
                "down_bytes_per_dispatch_steady": marg,
            }
    for tier in tiers:
        raw = derived[f"{tier}/raw"]
        sym = derived[f"{tier}/symmetric"]
        up_only = derived[f"{tier}/uplink_only"]
        marg_raw = raw["down_bytes_per_dispatch_steady"]
        marg_sym = sym["down_bytes_per_dispatch_steady"]
        derived[f"{tier}/summary"] = {
            "down_ratio_steady_raw_over_symmetric":
                None if not (marg_raw and marg_sym)
                else marg_raw / marg_sym,
            "t80_symmetric_no_worse_than_uplink_only":
                None if not (sym["t80"] and up_only["t80"])
                else sym["t80"] <= up_only["t80"],
        }
    rec = {"config": {"tiers": {k: v for k, v in tiers.items()},
                      "smoke": smoke, "frac": 0.1,
                      "epochs_per_round": EP},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_dlink.json").write_text(json.dumps(rec, indent=2))
    return {k: v for k, v in derived.items() if k.endswith("/summary")}


# --- hierarchical topology sweep --------------------------------------------

# server<->server link bandwidth tiers: the root's links divided by the
# tier factor — a datacenter backbone, a metro edge uplink, and a starved
# fog link where the hierarchy's compressed push path has to carry it
TOPOLOGY_TIERS = {"backbone/1": 1.0, "edge/40": 40.0, "starved/400": 400.0}
TOPOLOGY_LEAVES = (1, 2, 4)
BASE_SERVER_BW = 200e6          # bytes/s before the tier divisor


def fig_topology_sweep(smoke: bool = False, *, weights0=None, device=None):
    """Hierarchical federation sweep: 1 root x {1,2,4} leaf servers x
    server-link bandwidth tiers, compressed worker AND server links.

    1 leaf runs the passthrough identity topology (== the single-server
    baseline); multi-leaf runs split the same worker set round-robin into
    disjoint pools and re-aggregate through the root (sync leaf-push,
    delta-codec'd server links).  Emits ``BENCH_topology.json``;
    ``smoke=True``: 1 tier x {1,2} leaves, few rounds, same artifact
    shape.
    """
    tiers = {"edge/40": 40.0} if smoke else TOPOLOGY_TIERS
    leaves = (1, 2) if smoke else TOPOLOGY_LEAVES
    max_rounds = 4 if smoke else 120
    target = None if smoke else 0.8

    def _run(n_leaves, div):
        setup = make_setup([1] * 12, seed=0, noise=0.2, batch_size=64,
                           het="strong", weights0=_w0(weights0),
                           device=device)
        h = run_fl(setup, mode="sync", selector="all",
                   epochs_per_round=EP, max_rounds=max_rounds,
                   transport="topk_ef+int8", transport_frac=0.1,
                   target_accuracy=target,
                   topology="1x1" if n_leaves == 1 else n_leaves,
                   topology_kw=None if n_leaves == 1 else dict(
                       push="sync", server_codec="topk_ef+int8",
                       server_frac=0.1,
                       server_bandwidth=BASE_SERVER_BW / div))
        curve = [(p.time, p.accuracy, p.up_bytes, p.down_bytes) for p in h]
        return curve, {
            "t80": time_to_accuracy(h, 0.8),
            "final_accuracy": h[-1].accuracy,
            "root_versions": h[-1].version,
            # 1 leaf: worker-link bytes (the baseline's whole wire);
            # multi-leaf: exactly the server<->server payload bytes
            "up_bytes": h[-1].up_bytes,
            "down_bytes": h[-1].down_bytes,
        }

    curves, derived = {}, {}
    # the 1-leaf passthrough baseline has no server<->server wire, so the
    # tier divisor cannot affect it: run once, reference it per tier
    base_curve, base_derived = (_run(1, 1.0) if 1 in leaves
                                else (None, None))
    for tier, div in tiers.items():
        for n_leaves in leaves:
            name = f"{tier}/leaves{n_leaves}"
            if n_leaves == 1:
                curves[name], derived[name] = base_curve, base_derived
            else:
                curves[name], derived[name] = _run(n_leaves, div)
    for tier in tiers:
        one = derived[f"{tier}/leaves1"]
        rows = {n: derived[f"{tier}/leaves{n}"] for n in leaves if n > 1}
        derived[f"{tier}/summary"] = {
            "t80_leaves1": one["t80"],
            "t80_by_leaves": {n: r["t80"] for n, r in rows.items()},
            "server_wire_bytes_by_leaves": {
                n: r["up_bytes"] + r["down_bytes"] for n, r in rows.items()},
        }
    rec = {"config": {"tiers": dict(tiers), "leaves": list(leaves),
                      "smoke": smoke, "frac": 0.1,
                      "epochs_per_round": EP,
                      "base_server_bandwidth": BASE_SERVER_BW},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_topology.json").write_text(
        json.dumps(rec, indent=2))
    return {k: v for k, v in derived.items() if k.endswith("/summary")}


# --- chaos sweep ------------------------------------------------------------

# per-link drop probability tiers for the lossy-channel sweep; duplicates
# arrive at half the drop rate on top
CHAOS_LOSS_RATES = (0.0, 0.05, 0.1, 0.2)
CHAOS_SEED = 123


def fig_chaos_sweep(smoke: bool = False, *, weights0=None, device=None):
    """Fault-tolerance cost sweep: time-to-80% vs link loss rate, with
    the root killed mid-run, failover on vs off.

    Every cell is a 1x2 hierarchical federation (sync push, compressed
    worker AND server links) whose every link rides the seeded lossy
    channel (drop ``p``, duplicate ``p/2``, retransmit with backoff); the
    root dies right after its second global merge.  With failover the
    senior leaf is promoted and resumes delta dispatch; without it the
    run ends at the kill.  Each run is closed by the chaos auditor before
    it is recorded.  Emits ``BENCH_chaos.json``; ``smoke=True``: {0, 10%}
    loss, few rounds, same artifact shape.
    """
    from repro_torch.core.topology import parse_topology, run_fl_topology
    from repro_torch.runtime.faults import ChaosSchedule, audit_chaos_run

    rates = (0.0, 0.1) if smoke else CHAOS_LOSS_RATES
    max_rounds = 6 if smoke else 120
    target = None if smoke else 0.8
    kill_after = 1 if smoke else 2   # root dies after this global version

    def _run(drop_p, failover):
        setup = make_setup([1] * 12, seed=0, noise=0.2, batch_size=64,
                           het="strong", weights0=_w0(weights0),
                           device=device)
        sched = ChaosSchedule(seed=CHAOS_SEED, drop_p=drop_p,
                              dup_p=drop_p / 2, n_worker_kills=0)

        def on_build(topo):
            sched.apply(topo)        # lossy channel + ledger on every tier
            orig = topo._merge

            def merge_then_kill():
                orig()
                if topo.version == kill_after and not topo.done:
                    topo.loop.schedule(1e-3, topo.kill_root)
            topo._merge = merge_then_kill

        res = run_fl_topology(
            setup,
            topology=parse_topology("1x2", push="sync",
                                    server_codec="topk_ef+int8",
                                    server_frac=0.1,
                                    server_bandwidth=BASE_SERVER_BW / 40,
                                    root_failover=failover),
            mode="sync", selector="all", epochs_per_round=EP,
            max_rounds=max_rounds, target_accuracy=target,
            transport="topk_ef+int8", transport_frac=0.1,
            on_build=on_build)
        stats = audit_chaos_run(res.topology)   # books must close
        h = res.root_history
        curve = [(p.time, p.accuracy, p.retransmits) for p in h]
        return curve, {
            "t80": time_to_accuracy(h, 0.8),
            "final_accuracy": h[-1].accuracy,
            "root_versions": h[-1].version,
            "failovers": stats["failovers"],
            "retransmits": stats["retransmits"],
            "up_bytes": h[-1].up_bytes,
            "down_bytes": h[-1].down_bytes,
        }

    curves, derived = {}, {}
    for drop_p in rates:
        for failover in (True, False):
            name = f"loss{drop_p:g}/failover_{'on' if failover else 'off'}"
            curves[name], derived[name] = _run(drop_p, failover)
    base = derived[f"loss{rates[0]:g}/failover_on"]["t80"]
    lossy = derived.get("loss0.1/failover_on", {}).get("t80")
    derived["summary"] = {
        "t80_lossfree_failover_on": base,
        "t80_by_rate_failover_on": {
            f"{r:g}": derived[f"loss{r:g}/failover_on"]["t80"]
            for r in rates},
        "t80_by_rate_failover_off": {
            f"{r:g}": derived[f"loss{r:g}/failover_off"]["t80"]
            for r in rates},
        # acceptance: t80 under 10% loss within 25% of loss-free
        "t80_ratio_10pct_vs_lossfree": (
            lossy / base if base and lossy else None),
    }
    rec = {"config": {"loss_rates": list(rates), "smoke": smoke,
                      "seed": CHAOS_SEED, "kill_root_after": kill_after,
                      "topology": "1x2", "frac": 0.1,
                      "epochs_per_round": EP,
                      "server_bandwidth": BASE_SERVER_BW / 40},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_chaos.json").write_text(json.dumps(rec, indent=2))
    return derived["summary"]


# --- self-tuning transport sweep --------------------------------------------

# per-tier bandwidth divisors on the table's nominal profiles (30/80/200
# MB/s): backbone lands every link in the raw regime (encode cost beats
# byte savings), edge in int8's band, starved deep in topk_ef+int8's.
# The in-between band (~1-100 MB/s) is deliberately NOT a tier: there
# topk wins the per-transfer argmin but int8's fewer-rounds-to-0.8
# trajectory wins t80, and no latency-only pricing rule can see that
AUTOTUNE_TIERS = {"backbone/x.02": 0.02, "edge/x.25": 0.25,
                  "starved/x400": 400.0}
# the hand-picked candidates auto competes against, per tier
AUTOTUNE_FIXED = {
    "raw": dict(transport="raw"),
    "int8": dict(transport="int8"),
    "topk_ef+int8": dict(transport="topk_ef+int8", transport_frac=0.1),
}


def fig_autotune_sweep(smoke: bool = False, *, weights0=None, device=None):
    """One GLOBAL ``transport="auto"`` config vs every hand-picked codec,
    across bandwidth tiers: per tier, auto's t80 must land within 5% of
    the best fixed codec for THAT tier — with no per-tier tuning.

    ``selector="all"`` and an easy-enough task (noise=0.1), so the
    comparison measures the transport (see the reference's docstring).
    Emits ``BENCH_autotune.json``; ``smoke=True`` runs a tiny 1-tier
    config that still exercises auto against every fixed candidate and
    writes the same artifact shape.
    """
    tiers = ({"starved/x400": 400.0} if smoke else AUTOTUNE_TIERS)
    # the 0.8 crossing lands at round ~13 for the topk trajectory: the
    # smoke budget must clear it or auto_t80 degenerates to null
    max_rounds = 16 if smoke else 40
    target = None if smoke else 0.9
    configs = dict(AUTOTUNE_FIXED)
    configs["auto"] = dict(transport="auto")
    curves, derived = {}, {}
    for tier, div in tiers.items():
        for mode, tkw in configs.items():
            setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.1,
                               batch_size=64, het="strong",
                               weights0=_w0(weights0), device=device)
            for p in setup.profiles:
                p.bandwidth /= div
            h = run_fl(setup, mode="sync", selector="all",
                       epochs_per_round=EP, max_rounds=max_rounds,
                       target_accuracy=target, **tkw)
            name = f"{tier}/{mode}"
            curves[name] = [(p.time, p.accuracy, p.up_bytes, p.down_bytes)
                            for p in h]
            derived[name] = {
                "t80": time_to_accuracy(h, 0.8),
                "final_accuracy": h[-1].accuracy,
                "final_time": h[-1].time,
                "up_bytes": h[-1].up_bytes, "down_bytes": h[-1].down_bytes,
            }
    for tier in tiers:
        fixed_t80 = {m: derived[f"{tier}/{m}"]["t80"] for m in AUTOTUNE_FIXED}
        reached = {m: t for m, t in fixed_t80.items() if t is not None}
        best = min(reached, key=reached.get) if reached else None
        auto_t80 = derived[f"{tier}/auto"]["t80"]
        derived[f"{tier}/summary"] = {
            "best_fixed": best,
            "best_fixed_t80": reached.get(best),
            "auto_t80": auto_t80,
            # the acceptance bar: auto no worse than best fixed + 5%
            "auto_within_5pct_of_best":
                None if best is None or auto_t80 is None
                else auto_t80 <= 1.05 * reached[best],
        }
    rec = {"config": {"tiers": {k: v for k, v in tiers.items()},
                      "smoke": smoke, "frac": 0.1,
                      "epochs_per_round": EP},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_autotune.json").write_text(
        json.dumps(rec, indent=2))
    return {k: v for k, v in derived.items() if k.endswith("/summary")}


def fig_resume_sweep(smoke: bool = False, *, weights0=None, device=None):
    """Durable-federation cost sweep: kill a run at a checkpoint
    boundary, resume it from disk, and price both halves of the
    durability story — correctness (the stitched run must reach the
    SAME time-to-accuracy as the uninterrupted one, bit for bit) and
    overhead (snapshot size on disk and wall-clock save cost).

    Emits ``BENCH_resume.json``; ``smoke=True``: fewer rounds, same
    artifact shape and the same hard t80-parity assertion.
    """
    import tempfile

    from repro_torch.checkpoint import CheckpointManager

    max_rounds = 6 if smoke else 60
    every = 2
    modes = {
        "sync": dict(mode="sync", selector="all"),
        "async_delta": dict(mode="async", selector="all", async_delta=True),
    }
    tkw = dict(transport="topk_ef+int8", transport_frac=0.1)

    curves, derived = {}, {}
    for mname, mkw in modes.items():
        def _setup():
            return make_setup(TABLE_4_1["mnist_even"], seed=0, **REGIME,
                              weights0=_w0(weights0), device=device)

        t0 = time.time()
        h_full = run_fl(_setup(), epochs_per_round=EP,
                        max_rounds=max_rounds, **mkw, **tkw)
        t_uninterrupted = time.time() - t0

        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            h_part = run_fl(_setup(), epochs_per_round=EP,
                            max_rounds=max_rounds, **mkw, **tkw,
                            checkpoint_every=every, checkpoint_dir=d,
                            stop_after_checkpoints=1)
            t_killed = time.time() - t0
            mgr = CheckpointManager(d)
            sizes = [mgr._path(s).stat().st_size for s in mgr.steps()]
            t0 = time.time()
            h_res = run_fl(_setup(), epochs_per_round=EP,
                           max_rounds=max_rounds, **mkw, **tkw,
                           checkpoint_dir=d, resume=True)
            t_resumed = time.time() - t0

        full_rec = [(p.time.hex(), float(p.accuracy).hex()) for p in h_full]
        res_rec = [(p.time.hex(), float(p.accuracy).hex()) for p in h_res]
        t80_full = time_to_accuracy(h_full, 0.8)
        t80_res = time_to_accuracy(h_res, 0.8)
        # the acceptance gate: a killed+resumed run must be bit-identical
        # in simulated time, so t80 parity is EXACT, not approximate
        assert res_rec == full_rec, \
            f"{mname}: resumed history diverged from uninterrupted run"
        assert t80_res == t80_full, \
            f"{mname}: t80 parity broken ({t80_res} != {t80_full})"

        curves[mname] = [(p.time, p.accuracy) for p in h_res]
        derived[mname] = {
            "t80_uninterrupted": t80_full,
            "t80_resumed": t80_res,
            "t80_parity": t80_res == t80_full,
            "rounds_before_kill": len(h_part),
            "rounds_total": len(h_res),
            "checkpoint_bytes": sizes,
            "checkpoint_mib": [round(s / 2**20, 3) for s in sizes],
            "wall_s": {"uninterrupted": round(t_uninterrupted, 3),
                       "killed_segment": round(t_killed, 3),
                       "resumed_segment": round(t_resumed, 3)},
        }
    rec = {"config": {"smoke": smoke, "max_rounds": max_rounds,
                      "checkpoint_every": every, "frac": 0.1,
                      "epochs_per_round": EP},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_resume.json").write_text(
        json.dumps(rec, indent=2))
    return {m: {k: d[k] for k in ("t80_parity", "checkpoint_mib")}
            for m, d in derived.items()}


# --- heterogeneity scenario sweep (server optimizers) -----------------------

# server-side algorithms: plain FedAvg plus the server_opt variants and
# worker-side FedProx (a setup-level knob: the proximal term anchors on
# the params the worker actually received)
HETERO_ALGS = {
    "fedavg": {},
    "fedavgm": dict(server_opt="fedavgm", server_opt_kw={"momentum": 0.9}),
    "fedadam": dict(server_opt="fedadam", server_opt_kw={"lr": 0.05}),
    "feddyn": dict(server_opt="feddyn", server_opt_kw={"gamma": 0.25}),
    "fedprox": dict(fedprox_mu=0.01),          # make_setup kwarg, not run_fl
}
# Dirichlet label-skew severities: pathological, the thesis-relevant
# contended setting, and near-IID as the control column
HETERO_ALPHAS = (0.1, 0.3, 1.0)
HETERO_MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", **ASYNC_KW),
}


def fig_heterogeneity_sweep(smoke: bool = False, *, weights0=None,
                            device=None):
    """Non-IID heterogeneity sweep: algorithm x Dirichlet alpha x
    sync/async (raw transport), plus a compressed-transport arm at the
    contended alpha=0.3 column (sync, symmetric topk_ef+int8).

    Emits ``BENCH_hetero.json``.  The derived summary carries the
    acceptance cells: at every alpha <= 0.3 column, whether FedAvgM or
    FedAdam reaches t80 faster than plain FedAvg (a FedAvg that never
    reaches 80% counts as beaten by any optimizer that does).
    ``smoke=True`` runs a tiny alpha=0.3 sync/async grid that writes the
    same artifact shape.
    """
    alphas = (0.3,) if smoke else HETERO_ALPHAS
    algs = (("fedavg", "fedavgm", "fedadam") if smoke
            else tuple(HETERO_ALGS))
    modes = HETERO_MODES
    # an async "round" is ONE worker update (staleness-weighted merge),
    # a sync round is a full-cohort pass — 10x the rounds makes the two
    # columns comparable in effective passes over the worker set
    rounds = ({"sync": 14, "async": 140} if smoke
              else {"sync": 40, "async": 400})
    curves, derived = {}, {}

    def _cell(alpha, alg, mkw, tkw):
        akw = dict(HETERO_ALGS[alg])
        setup_kw = dict(REGIME)
        if "fedprox_mu" in akw:
            setup_kw["fedprox_mu"] = akw.pop("fedprox_mu")
        setup = make_setup(TABLE_4_1["mnist_even"], seed=0, **setup_kw,
                           weights0=_w0(weights0), device=device)
        h = run_fl(setup, epochs_per_round=EP,
                   max_rounds=rounds["async" if mkw.get("mode") == "async"
                                     else "sync"],
                   partition="dirichlet",
                   partition_kw={"alpha": alpha, "seed": 0},
                   **mkw, **akw, **tkw)
        return h

    for alpha in alphas:
        for mname, mkw in modes.items():
            for alg in algs:
                h = _cell(alpha, alg, mkw, dict(transport="raw"))
                name = f"a{alpha}/{mname}/{alg}"
                curves[name] = [(p.time, p.accuracy) for p in h]
                derived[name] = {"t80": time_to_accuracy(h, 0.8),
                                 "final_accuracy": h[-1].accuracy}
    # compressed-transport arm: the contended column under symmetric
    # lossy links (FedProx's anchor is the decoded downlink here)
    comp_alpha = alphas[0] if smoke else 0.3
    if not smoke:
        for alg in algs:
            h = _cell(comp_alpha, alg, modes["sync"],
                      dict(transport="topk_ef+int8", transport_frac=0.1))
            name = f"a{comp_alpha}/sync_topk/{alg}"
            curves[name] = [(p.time, p.accuracy) for p in h]
            derived[name] = {"t80": time_to_accuracy(h, 0.8),
                             "final_accuracy": h[-1].accuracy}

    # acceptance summary: per low-alpha column, does a server optimizer
    # (FedAvgM or FedAdam) beat plain FedAvg to 80%?
    def _beats(base_t80, opt_t80):
        if opt_t80 is None:
            return False
        return base_t80 is None or opt_t80 < base_t80

    summary = {}
    cols = [(a, m) for a in alphas if a <= 0.3 for m in modes]
    if not smoke:
        cols.append((comp_alpha, "sync_topk"))
    for alpha, mname in cols:
        base = derived[f"a{alpha}/{mname}/fedavg"]["t80"]
        opts = {alg: derived[f"a{alpha}/{mname}/{alg}"]["t80"]
                for alg in ("fedavgm", "fedadam")
                if f"a{alpha}/{mname}/{alg}" in derived}
        wins = {alg: _beats(base, t) for alg, t in opts.items()}
        reached = [t for t in opts.values() if t is not None]
        summary[f"a{alpha}/{mname}"] = {
            "fedavg_t80": base,
            "opt_t80": opts,
            # when nobody reaches 80% in budget (async at extreme skew),
            # final accuracy still ranks the algorithms
            "fedavg_final":
                derived[f"a{alpha}/{mname}/fedavg"]["final_accuracy"],
            "opt_final": {alg: derived[f"a{alpha}/{mname}/{alg}"]
                          ["final_accuracy"] for alg in opts},
            "server_opt_beats_fedavg": any(wins.values()),
            "speedup_vs_fedavg":
                None if not (reached and base) else base / min(reached),
        }
    derived["summary"] = summary
    rec = {"config": {"smoke": smoke, "alphas": list(alphas),
                      "algs": list(algs), "modes": list(modes),
                      "max_rounds": rounds, "epochs_per_round": EP,
                      "regime": REGIME},
           "curves": curves, "derived": derived}
    BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
    (BENCH_RESULTS / "BENCH_hetero.json").write_text(json.dumps(rec, indent=2))
    return summary


ALL = {
    "fig4_1_sequential_vs_fl": fig4_1_sequential_vs_fl,
    "fig4_2_even_vs_uneven": fig4_2_even_vs_uneven,
    "fig4_3_random_vs_sequential": fig4_3_random_vs_sequential,
    "fig4_4_rminrmax_vs_sequential": fig4_4_rminrmax_vs_sequential,
    "fig4_5_rminrmax_initialisation": fig4_5_rminrmax_initialisation,
    "fig4_6_alg2_sync": fig4_6_alg2_sync,
    "fig4_7_alg2_async": fig4_7_alg2_async,
    "table5_1_time_to_accuracy": table5_1_time_to_accuracy,
    "fig_30workers": fig30_workers,
    "fig_dlink_bandwidth_sweep": fig_dlink_bandwidth_sweep,
    "fig_topology_sweep": fig_topology_sweep,
    "fig_chaos_sweep": fig_chaos_sweep,
    "fig_autotune_sweep": fig_autotune_sweep,
    "fig_resume_sweep": fig_resume_sweep,
    "fig_heterogeneity_sweep": fig_heterogeneity_sweep,
}
# one smoke flag per sweep, as fl_figures.py and benchmarks/run.py have
# them ("scale" is torch_scale_bench's)
SMOKE_FLAGS = {"dlink": "fig_dlink_bandwidth_sweep",
               "topology": "fig_topology_sweep",
               "chaos": "fig_chaos_sweep", "scale": None,
               "autotune": "fig_autotune_sweep",
               "resume": "fig_resume_sweep",
               "hetero": "fig_heterogeneity_sweep"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", default=None,
                    help="comma-separated names of ALL to run")
    ap.add_argument("--results", default=None,
                    help="write under this directory instead of "
                         "benchmarks/results/torch")
    for flag in SMOKE_FLAGS:
        ap.add_argument(f"--smoke-{flag}", action="store_true",
                        help=f"run only the {flag} sweep, smoke form")
    args = ap.parse_args(argv)
    smoke_only = [f for f in SMOKE_FLAGS
                  if getattr(args, f"smoke_{f}")]
    if len(smoke_only) > 1:
        ap.error("one --smoke-* flag at a time")
    args.smoke_only = smoke_only[0] if smoke_only else None
    names = list(ALL) if args.only is None else args.only.split(",")
    unknown = [n for n in names if n not in ALL]
    if unknown:
        ap.error(f"unknown names {unknown}; have {list(ALL)}")
    args.names = names
    return args


def main(argv=None) -> None:
    global RESULTS, BENCH_RESULTS
    args = parse_args(argv)
    if args.results is not None:
        BENCH_RESULTS = Path(args.results)
        RESULTS = BENCH_RESULTS / "figures"
    device = device_or_exit(args.device)
    weights0 = load_weights0()
    if args.smoke_only == "scale":
        # a sibling script: its directory is on sys.path when this file
        # runs as one
        import torch_scale_bench
        torch_scale_bench.main(smoke=True, device=device,
                               results=args.results)
        return
    if args.smoke_only is not None:
        fn = ALL[SMOKE_FLAGS[args.smoke_only]]
        print(json.dumps(fn(smoke=True, weights0=weights0, device=device),
                         indent=2))
        return
    card = card_name()
    print(f"card: {card}; device {device}", flush=True)
    run = {"card": card, "device": str(device), "figures": {}}
    for name in args.names:
        t0 = time.perf_counter()
        derived = ALL[name](weights0=weights0, device=device)
        wall = time.perf_counter() - t0
        run["figures"][name] = {"wall_s": wall, "derived": derived}
        print(name, f"{wall:.3f} s", json.dumps(derived, default=str),
              flush=True)
        BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
        (BENCH_RESULTS / "figures_run.json").write_text(
            json.dumps(run, indent=2, default=str))


if __name__ == "__main__":
    main()
