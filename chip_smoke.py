#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Card identity: ``nvidia-smi`` name and power limit; compute capability
   (9, 0) is required.
2. Build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Kernels: hold each kernel against its plain PyTorch version on the
   card at the paths' shapes (fedavg W = 30 and 2, N = 101,888 and a
   ragged N = 1000, within 1e-6; encode and decode at N = 101,888 and
   1000, bit-exact; the server-optimizer step at N = 101,888, 29,184 (the
   padded MNIST CNN) and 1000 with the FedAvgM, FedDyn and FedAdam
   scalars, bit-exact, fresh and with its state written in place), then
   time kernel, plain version and one-call library yardstick with CUDA
   events (median of 50 cold-L2 runs after warm-up), beside the least
   time the card could take.
4. Main path: the paper's 30-worker MNIST experiment at full MLP width
   (784-128-10, 101,770 parameters) through ``make_setup`` -> ``run_fl``,
   20 rounds x 10 local epochs, in sync / async / async_delta /
   time_based, with the raw transport and with top-k+int8 uplinks.
5. Heterogeneity: the non-IID experiment of ``benchmarks/fl_figures.py``
   (REGIME: 10 workers, batch 64, het extreme, Dirichlet alpha 0.3) at
   full MLP width, 10 local epochs: sync 40 rounds with FedAvgM
   (momentum 0.9), FedAdam (lr 0.05), FedDyn (gamma 0.25) and worker-side
   FedProx (mu 0.01); async FedAdam for 100 merges (alpha 0.9, staleness
   power 0.25, linear weights); sync FedAdam over symmetric top-k+int8
   links at frac 0.1, 40 rounds.
6. CNN: the thesis' Listing 4.1 CNN at MNIST width (28,938 parameters),
   the same regime without the Dirichlet split, sync FedAvg and FedAdam,
   20 rounds; FedAdam must reach 0.8 accuracy.

Every run of phases 4-6 starts with every launch counter at 0 and reads
them after; the counters must show each kernel on the runs that use it
(and the optimizer step exactly once per merge).  Every raw run is
repeated on the CPU in this process from the same initial weights: every
history field but accuracy must match exactly.  Accuracy cannot match
point for point: SGD over these runs is chaotic, and a one-ulp change to
one initial weight alone moves it (``SPREAD``, measured on the CPU with
``tools/torch_accuracy_spread.py``).  So the card must stay within
``gap_bounds`` of the CPU at every point and in the mean of the last five
points.  The top-k runs are not compared field by field (kept counts
follow the numerics).
7. Result: the ``kernels`` JSON line, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

A full report goes to ``chiprun_out/chip_smoke_report.json``, also when a
phase fails.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
N_TIMED = 50
EPOCHS = 10
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")
MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
    "async_delta": dict(mode="async", selector="all", async_delta=True),
    "time_based": dict(mode="sync", selector="time_based",
                       selector_kw={"r": EPOCHS, "T0": 0.0, "A": 0.01}),
}
TRANSPORTS = {
    "raw": dict(transport="raw"),
    "uplink_only": dict(transport="topk_ef+int8", transport_down="raw",
                        transport_frac=0.1),
}
REGIME = dict(noise=0.2, batch_size=64, het="extreme")
DIRICHLET = dict(partition="dirichlet",
                 partition_kw={"alpha": 0.3, "seed": 0})
ASYNC_KW = dict(mode="async", selector="all", async_latest_table=False,
                async_alpha=0.9, async_stale_pow=0.25, aggregator="linear")
FEDAVGM = dict(server_opt="fedavgm", server_opt_kw={"momentum": 0.9})
FEDADAM = dict(server_opt="fedadam", server_opt_kw={"lr": 0.05})
FEDDYN = dict(server_opt="feddyn", server_opt_kw={"gamma": 0.25})
SYNC = MODES["sync"]


def _run(phase, model, rounds, run_kw, setup_kw=None, compare=True):
    return dict(phase=phase, model=model, rounds=rounds, run_kw=run_kw,
                setup_kw=setup_kw or {}, compare=compare)


# run key -> what it drives; "compare": repeated on the CPU field by field
RUNS = {f"{t}/{m}": _run("main", "mlp", 20, {**MODES[m], **TRANSPORTS[t]},
                         compare=t == "raw")
        for t in TRANSPORTS for m in MODES}
RUNS.update({
    "hetero/sync/fedavgm": _run("hetero", "mlp", 40,
                                {**SYNC, **DIRICHLET, **FEDAVGM}),
    "hetero/sync/fedadam": _run("hetero", "mlp", 40,
                                {**SYNC, **DIRICHLET, **FEDADAM}),
    "hetero/sync/feddyn": _run("hetero", "mlp", 40,
                               {**SYNC, **DIRICHLET, **FEDDYN}),
    "hetero/sync/fedprox": _run("hetero", "mlp", 40, {**SYNC, **DIRICHLET},
                                setup_kw={"fedprox_mu": 0.01}),
    "hetero/async/fedadam": _run("hetero", "mlp", 100,
                                 {**ASYNC_KW, **DIRICHLET, **FEDADAM}),
    "hetero/sync_topk/fedadam": _run(
        "hetero", "mlp", 40, {**SYNC, **DIRICHLET, **FEDADAM,
                              "transport": "topk_ef+int8",
                              "transport_frac": 0.1}, compare=False),
    "cnn/sync/fedavg": _run("cnn", "cnn", 20, SYNC),
    "cnn/sync/fedadam": _run("cnn", "cnn", 20, {**SYNC, **FEDADAM}),
})
# phase -> (batches per worker table, make_setup kwargs); MNIST width
PHASES = {"main": ("TABLE_4_2", dict(het="strong")),
          "hetero": ("TABLE_4_1", REGIME),
          "cnn": ("TABLE_4_1", REGIME)}
# How far one ulp of initial-weight noise moves accuracy on the CPU: the
# largest of 10 perturbations made by tools/torch_accuracy_spread.py, as
# (gap at any point, gap of the last-5 mean).
SPREAD = {
    "hetero/sync/fedavgm": (0.5645, 0.4695),
    "hetero/sync/fedadam": (0.2734, 0.1883),
    "hetero/sync/feddyn": (0.2461, 0.0152),
    "hetero/sync/fedprox": (0.2305, 0.0637),
    "hetero/async/fedadam": (0.0547, 0.0055),
    "cnn/sync/fedavg": (0.0117, 0.0008),
    "cnn/sync/fedadam": (0.1562, 0.0016),
}
GAP_FLOOR = (0.1, 0.05)
MAIN_GAPS = (0.2, 0.05)         # the main path's bounds


def gap_bounds(key):
    """Card vs CPU accuracy bounds of one run: MAIN_GAPS on the main
    path; elsewhere twice the run's CPU spread (the card's rounding
    differs at every operation, the spread's at one weight once), rounded
    up to 0.01, at least GAP_FLOOR and at most 1."""
    if RUNS[key]["phase"] == "main":
        return MAIN_GAPS
    return tuple(min(1.0, max(f, math.ceil(200 * s) / 100))
                 for s, f in zip(SPREAD[key], GAP_FLOOR))


# kernel -> (launch counter key, the runs that must show it)
REQUIRED = {
    "fedavg_agg_flat": ("agg", ["raw/sync", "raw/time_based",
                                "raw/async_delta", "hetero/sync/fedavgm",
                                "cnn/sync/fedavg"]),
    "fedavg_mix_flat": ("mix", ["raw/async", "raw/async_delta",
                                "hetero/async/fedadam"]),
    "topk_quant_encode": ("encode", [f"uplink_only/{m}" for m in MODES]
                          + ["hetero/sync_topk/fedadam"]),
    "dequant_add": ("decode", [f"uplink_only/{m}" for m in MODES]
                    + ["hetero/sync_topk/fedadam"]),
    "server_opt_step_flat_mom": ("mom", ["hetero/sync/fedavgm",
                                         "hetero/sync/feddyn"]),
    "server_opt_step_flat_adam": ("adam", [
        "hetero/sync/fedadam", "hetero/async/fedadam",
        "hetero/sync_topk/fedadam", "cnn/sync/fedadam"]),
}
# server_opt -> the launch counter of its form (B5a momentum, B5b adam)
OPT_COUNTER = {"fedavgm": "mom", "feddyn": "mom", "fedadam": "adam"}
OPT_SCALARS = {"fedavgm": [0.9, 1.0, 0.0, 1.0],
               "feddyn": [1.0, 1.0, 1.0, 0.25],
               "fedadam": [0.9, 0.99, 0.05, 1e-3, 0.0, 0.0]}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each.

    A spin of about a millisecond and the flush (256 MiB written) are
    queued before the start event, so the host has issued the timed call
    before the card reaches it: the events time the card's work, not the
    host's dispatch."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn) -> float:
        for _ in range(5):
            fn()
        pairs = []
        for _ in range(N_TIMED):
            torch.cuda._sleep(2_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def launch_counters():
    """Counter key -> the wrapper module's LAUNCHES dict."""
    from repro_torch.kernels import fedavg_agg, server_opt, topk_quant
    return {"agg": fedavg_agg.LAUNCHES, "mix": fedavg_agg.LAUNCHES,
            "encode": topk_quant.LAUNCHES, "decode": topk_quant.LAUNCHES,
            "mom": server_opt.LAUNCHES, "adam": server_opt.LAUNCHES}


def check_server_opt(dev, g, errs):
    """B5a/B5b against the plain version, fresh and in place, at the
    paths' widths and every optimizer's scalars."""
    from repro_torch.kernels import ref, server_opt
    for n in (101_888, 29_184, 1000):
        prev, merged, m, v = (torch.randn(n, device=dev, generator=g)
                              for _ in range(4))
        v = v.abs()
        for opt, sc in OPT_SCALARS.items():
            adam = opt == "fedadam"
            name = ("server_opt_step_flat_adam" if adam
                    else "server_opt_step_flat_mom")
            sc = np.asarray(sc, np.float32)
            plain = ref.reference_server_opt(prev, merged, m, v, sc,
                                             adam=adam)
            fresh = server_opt.server_opt_step_flat(prev, merged, m, v, sc,
                                                    adam=adam)
            m2, v2 = m.clone(), v.clone()
            inplace = server_opt.server_opt_step_flat(
                prev, merged, m2, v2, sc, adam=adam, m_out=m2, v_out=v2)
            for got in (fresh, inplace):
                for a, b in zip(got, plain):
                    if b is not None:
                        errs[name] = max(errs[name], max_err(a, b))


def check_kernels(dev):
    """Phase 3: correctness at several shapes, then timing at the main
    path's shapes.  Returns one record per kernel."""
    from repro_torch.core import transport
    from repro_torch.kernels import fedavg_agg, ref, server_opt, topk_quant
    g = torch.Generator(device=dev).manual_seed(0)
    N = 101_888
    errs = {k: 0.0 for k in REQUIRED}
    for W, n in ((30, N), (2, N), (30, 1000), (3, 1000)):
        rows = torch.randn(W, n, device=dev, generator=g)
        w = torch.rand(W, device=dev, generator=g)
        w /= w.sum()
        server = torch.randn(n, device=dev, generator=g)
        e = max_err(fedavg_agg.fedavg_agg_flat(rows, w),
                    ref.reference_fedavg(rows, w))
        errs["fedavg_agg_flat"] = max(errs["fedavg_agg_flat"], e)
        for s in (0.1, 1.0):
            wvec = torch.cat([torch.full((1,), s, device=dev), w])
            plain = ref.reference_fedavg_mix(rows, w, server, wvec[0])
            fresh = fedavg_agg.fedavg_mix_flat(rows, wvec, server)
            srv = server.clone()
            inplace = fedavg_agg.fedavg_mix_flat(rows, wvec, srv, out=srv)
            if not torch.equal(inplace, fresh):
                raise AssertionError("fedavg_mix_flat: in-place differs")
            errs["fedavg_mix_flat"] = max(errs["fedavg_mix_flat"],
                                          max_err(fresh, plain))
    for n in (N, 1000):
        x = torch.randn(n, device=dev, generator=g) * 0.01
        scale = transport._int8_scale(x)
        for thresh in (transport.topk_threshold(x, max(1, n // 10), n),
                       torch.zeros((), device=dev)):
            q, r = topk_quant.topk_quant_encode(x, thresh, scale)
            qp, rp = ref.reference_topk_quant_encode(x, thresh, scale)
            e = max(max_err(q, qp), max_err(r, rp))
            errs["topk_quant_encode"] = max(errs["topk_quant_encode"], e)
            base = torch.randn(n, device=dev, generator=g)
            e = max_err(topk_quant.dequant_add(q, scale, base),
                        ref.reference_dequant_add(q, scale, base))
            errs["dequant_add"] = max(errs["dequant_add"], e)
    check_server_opt(dev, g, errs)
    torch.cuda.synchronize()
    limits = {"fedavg_agg_flat": 1e-6, "fedavg_mix_flat": 1e-6,
              "topk_quant_encode": 0.0, "dequant_add": 0.0,
              "server_opt_step_flat_mom": 0.0,
              "server_opt_step_flat_adam": 0.0}
    for k, lim in limits.items():
        if not errs[k] <= lim:
            raise AssertionError(f"{k}: max |kernel - plain| = {errs[k]} "
                                 f"> {lim}")
        print(f"check {k}: max |kernel - plain| = {errs[k]:g} "
              f"(limit {lim:g})")

    # timing at the main path's shapes: W = 30 rows of N = 101,888
    timer = Timer(dev)
    W = 30
    rows = torch.randn(W, N, device=dev, generator=g)
    w = torch.rand(W, device=dev, generator=g)
    w /= w.sum()
    wvec = torch.cat([torch.full((1,), 0.1, device=dev), w])
    server = torch.randn(N, device=dev, generator=g)
    x = torch.randn(N, device=dev, generator=g) * 0.01
    scale = transport._int8_scale(x)
    thresh = transport.topk_threshold(x, N // 10, N)
    q, _ = topk_quant.topk_quant_encode(x, thresh, scale)
    base = torch.randn(N, device=dev, generator=g)
    scale_f = float(scale)
    prev, merged, m, v = (torch.randn(N, device=dev, generator=g)
                          for _ in range(4))
    v = v.abs()
    mom_sc = np.asarray(OPT_SCALARS["fedavgm"], np.float32)
    adam_sc = np.asarray(OPT_SCALARS["fedadam"], np.float32)
    cases = {
        "fedavg_agg_flat": (
            lambda: fedavg_agg.fedavg_agg_flat(rows, w),
            lambda: ref.reference_fedavg(rows, w),
            lambda: torch.mv(rows.t(), w),
            (W * N + W + N) * 4, 2 * W * N),
        "fedavg_mix_flat": (
            lambda: fedavg_agg.fedavg_mix_flat(rows, wvec, server,
                                               out=server),
            lambda: ref.reference_fedavg_mix(rows, w, server, wvec[0]),
            lambda: torch.addmv(server, rows.t(), w, beta=0.1),
            (W * N + W + 1 + 2 * N) * 4, 2 * W * N + 2 * N),
        "topk_quant_encode": (
            lambda: topk_quant.topk_quant_encode(x, thresh, scale),
            lambda: ref.reference_topk_quant_encode(x, thresh, scale),
            None,
            N * 4 + 8 + N + N * 4, 6 * N),
        "dequant_add": (
            lambda: topk_quant.dequant_add(q, scale, base),
            lambda: ref.reference_dequant_add(q, scale, base),
            lambda: torch.add(base, q, alpha=scale_f),
            N + 4 + N * 4 + N * 4, 2 * N),
        # the main path's call: state updated in place; 3 reads, 2 writes
        "server_opt_step_flat_mom": (
            lambda: server_opt.server_opt_step_flat(
                prev, merged, m, None, mom_sc, adam=False, m_out=m),
            lambda: ref.reference_server_opt(prev, merged, m, None, mom_sc,
                                             adam=False),
            None,
            5 * N * 4 + 16, 8 * N),
        # 4 reads, 3 writes
        "server_opt_step_flat_adam": (
            lambda: server_opt.server_opt_step_flat(
                prev, merged, m, v, adam_sc, adam=True, m_out=m, v_out=v),
            lambda: ref.reference_server_opt(prev, merged, m, v, adam_sc,
                                             adam=True),
            None,
            7 * N * 4 + 16, 13 * N),
    }
    sources = {"fedavg_agg_flat": ("fedavg_agg.cu", "fedavg_agg.py:68"),
               "fedavg_mix_flat": ("fedavg_agg.cu", "fedavg_agg.py:111"),
               "topk_quant_encode": ("topk_quant.cu", "topk_quant.py:60"),
               "dequant_add": ("topk_quant.cu", "topk_quant.py:89"),
               "server_opt_step_flat_mom": ("server_opt.cu",
                                            "fedavg_agg.py:208"),
               "server_opt_step_flat_adam": ("server_opt.cu",
                                             "fedavg_agg.py:195")}
    records = {}
    for name, (kern, plain, lib, n_bytes, flops) in cases.items():
        b_ms, b_by = bound_ms(n_bytes, flops)
        src, tpu = sources[name]
        records[name] = {
            "name": name, "route": "cuda", "ok": True,
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": 0, "max_abs_err": errs[name],
            "ms": timer(kern), "plain_ms": timer(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else timer(lib)}
        print(f"time {name}: kernel {records[name]['ms']:.4f} ms, plain "
              f"{records[name]['plain_ms']:.4f} ms, library "
              f"{records[name]['library_ms']} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
    # the comparison launches above do not count toward the paths' runs:
    # each run sets every counter to 0 before it starts
    return records


class Setups:
    """One setup per (phase, model, make_setup extras) and device; every
    device starts from the card's initial weights of that model."""

    def __init__(self, dev):
        self.dev = dev
        self._made = {}
        self._weights0 = {}

    def get(self, spec, device):
        from repro_torch.configs.paper_cnn import MNIST_CNN
        from repro_torch import core
        table, kw = PHASES[spec["phase"]]
        key = (spec["phase"], spec["model"],
               tuple(sorted(spec["setup_kw"].items())), str(device))
        if key not in self._made:
            w0 = self._weights0.get((spec["phase"], spec["model"]))
            setup = core.make_setup(
                getattr(core, table)["mnist_even"], cfg=MNIST_CNN,
                model=spec["model"], seed=0, **kw, **spec["setup_kw"],
                weights0=w0, device=device)
            if w0 is None:
                self._weights0[(spec["phase"], spec["model"])] = {
                    k: v.cpu().numpy() for k, v in setup.weights0.items()}
            self._made[key] = setup
        return self._made[key]


def drive(key, setup, report):
    """One run on the card, every launch counter set to 0 just before it
    and read just after."""
    from repro_torch.core import run_fl
    spec = RUNS[key]
    counters = launch_counters()
    for c in counters.values():
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = run_fl(setup, epochs_per_round=EPOCHS, max_rounds=spec["rounds"],
               **spec["run_kw"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: counters[k][k] for k in counters}
    rounds = h[-1].version
    report[key] = {"history": [vars(p) for p in h], "launches": launches,
                   "wall_s": wall, "s_per_round": wall / max(rounds, 1)}
    print(f"run {key}: {rounds} rounds, final accuracy "
          f"{h[-1].accuracy:.4f}, {wall / max(rounds, 1):.4f} s per round, "
          f"launches {launches}")
    if rounds != spec["rounds"]:
        raise AssertionError(f"{key}: {rounds} rounds, not {spec['rounds']}")
    if not all(np.isfinite(p.accuracy) for p in h):
        raise AssertionError(f"{key}: non-finite accuracy")
    opt_ctr = OPT_COUNTER.get(spec["run_kw"].get("server_opt"))
    for ctr in ("mom", "adam"):
        want = rounds if ctr == opt_ctr else 0
        if launches[ctr] != want:
            raise AssertionError(f"{key}: {launches[ctr]} {ctr} optimizer "
                                 f"steps, expected one per merge ({want})")


def compare_with_cpu(key, setup, report):
    """The run again on the CPU from the same initial weights: every
    non-accuracy field equal, accuracy within ``gap_bounds``."""
    from repro_torch.core import run_fl
    spec = RUNS[key]
    h = run_fl(setup, epochs_per_round=EPOCHS, max_rounds=spec["rounds"],
               **spec["run_kw"])
    gpu = report[key]["history"]
    if len(gpu) != len(h):
        raise AssertionError(f"{key}: {len(gpu)} points on the card, "
                             f"{len(h)} on the CPU")
    for g, c in zip(gpu, h):
        for f in FIELDS:
            if g[f] != getattr(c, f):
                raise AssertionError(f"{key}: {f} {g[f]} on the card, "
                                     f"{getattr(c, f)} on the CPU")
    a_gpu = np.array([g["accuracy"] for g in gpu])
    a_cpu = np.array([c.accuracy for c in h])
    got = (float(np.abs(a_gpu - a_cpu).max()),
           float(abs(a_gpu[-5:].mean() - a_cpu[-5:].mean())))
    bounds = gap_bounds(key)
    report[key].update(cpu_accuracy=a_cpu.tolist(), cpu_gaps=got,
                       gap_bounds=bounds)
    print(f"cpu {key}: history fields equal; accuracy gap {got[0]:.4f} "
          f"at worst point, {got[1]:.4f} in the last-5 mean (limits "
          f"{bounds})")
    if any(g > b for g, b in zip(got, bounds)):
        raise AssertionError(f"{key}: card vs CPU accuracy gaps {got} "
                             f"above {bounds}")


def run_phase(phase, setups, report):
    """Phases 4-6: every run of ``phase`` on the card, then the raw ones
    on the CPU."""
    keys = [k for k, s in RUNS.items() if s["phase"] == phase]
    for key in keys:
        drive(key, setups.get(RUNS[key], setups.dev), report)
    if phase == "main":
        setup = setups.get(RUNS["raw/sync"], setups.dev)
        n_params = sum(p.numel() for p in setup.weights0.values())
        if n_params != 101_770:
            raise AssertionError(f"expected 101,770 MLP parameters, got "
                                 f"{n_params}")
        final = report["raw/sync"]["history"][-1]["accuracy"]
        if final < 0.50:
            raise AssertionError(f"raw/sync final accuracy {final} < 0.50")
    if phase == "cnn":
        setup = setups.get(RUNS["cnn/sync/fedavg"], setups.dev)
        n_params = sum(p.numel() for p in setup.weights0.values())
        if n_params != 28_938:
            raise AssertionError(f"expected 28,938 CNN parameters, got "
                                 f"{n_params}")
        best = max(p["accuracy"] for p in report["cnn/sync/fedadam"]
                   ["history"])
        if best < 0.8:
            raise AssertionError(f"cnn/sync/fedadam best accuracy {best} "
                                 f"< 0.8")
    for key in keys:
        if RUNS[key]["compare"]:
            compare_with_cpu(key, setups.get(RUNS[key], "cpu"), report)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    print(f"capability: {cap}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"needs compute capability (9, 0), got {cap}")

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().relative_to(ROOT)})")
    print(_build.build_log.strip())

    records = check_kernels(dev)
    runs = {}
    try:
        setups = Setups(dev)
        for phase in PHASES:
            t0 = time.perf_counter()
            run_phase(phase, setups, runs)
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        for name, (ctr, keys) in REQUIRED.items():
            for key in keys:
                if runs[key]["launches"][ctr] < 1:
                    raise AssertionError(f"{name} never launched in {key}")
            records[name]["launches"] = sum(r["launches"][ctr]
                                            for r in runs.values())
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_report.json").write_text(json.dumps(
            {"card": card, "kernels": list(records.values()), "runs": runs},
            indent=1))
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
