#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Card identity: ``nvidia-smi`` name and power limit; compute capability
   (9, 0) is required.
2. Build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Kernels: hold each kernel against its plain PyTorch version on the
   card at the main path's shapes (W = 30 and 2, N = 101,888) and a
   ragged N = 1000 (fedavg within 1e-6; encode and decode bit-exact),
   then time kernel, plain version and one-call library yardstick with
   CUDA events (median of 50 cold-L2 runs after warm-up), beside the
   least time the card could take.
4. Main path: the paper's 30-worker MNIST experiment at full MLP width
   (784-128-10, 101,770 parameters) through ``make_setup`` -> ``run_fl``,
   20 rounds x 10 local epochs, in sync / async / async_delta /
   time_based, with the raw transport and with top-k+int8 uplinks.  The
   launch counters must show every kernel ran; the raw runs are repeated
   on the CPU in this process from the same initial weights, and every
   history field but accuracy must match exactly.  Accuracy cannot match
   point for point: 20 rounds of SGD at lr 0.1 are chaotic, and a one-ulp
   change to one initial weight alone moves accuracy by up to 0.16 at a
   point and 0.03 in the mean of the last five points (CPU,
   ``tools/torch_accuracy_spread.py``).  So the card must stay within
   0.2 of the CPU at every point (a broken merge or codec lands near
   chance, 0.1, far outside) and within 0.05 in the last-five mean.
5. Result: the ``kernels`` JSON line, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

A full report goes to ``chiprun_out/chip_smoke_report.json``, also when a
phase fails.
"""
import json
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
EPOCHS, ROUNDS = 10, 20
POINT_GAP, LAST5_GAP = 0.2, 0.05      # card vs CPU accuracy, see above
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
# kernel -> (launch counter module key, which main-path runs must show it)
REQUIRED = {
    "fedavg_agg_flat": ("agg", ["raw/sync", "raw/time_based",
                                "raw/async_delta"]),
    "fedavg_mix_flat": ("mix", ["raw/async", "raw/async_delta"]),
    "topk_quant_encode": ("encode", [f"uplink_only/{m}" for m in MODES]),
    "dequant_add": ("decode", [f"uplink_only/{m}" for m in MODES]),
}


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


def check_kernels(dev):
    """Phase 3: correctness at several shapes, then timing at the main
    path's shapes.  Returns one record per kernel."""
    from repro_torch.core import transport
    from repro_torch.kernels import fedavg_agg, ref, topk_quant
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
    torch.cuda.synchronize()
    limits = {"fedavg_agg_flat": 1e-6, "fedavg_mix_flat": 1e-6,
              "topk_quant_encode": 0.0, "dequant_add": 0.0}
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
    }
    sources = {"fedavg_agg_flat": ("fedavg_agg.cu", "fedavg_agg.py:68"),
               "fedavg_mix_flat": ("fedavg_agg.cu", "fedavg_agg.py:111"),
               "topk_quant_encode": ("topk_quant.cu", "topk_quant.py:60"),
               "dequant_add": ("topk_quant.cu", "topk_quant.py:89")}
    counts = (dict(fedavg_agg.LAUNCHES), dict(topk_quant.LAUNCHES))
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
    # the comparison launches above do not count toward the main path
    fedavg_agg.LAUNCHES.update(counts[0])
    topk_quant.LAUNCHES.update(counts[1])
    return records


def run_main_path(dev, records, report):
    """Phase 4: the eight main-path runs on the card, the raw ones again
    on the CPU; fills ``report`` with every run."""
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core import TABLE_4_2, make_setup, run_fl
    from repro_torch.kernels import fedavg_agg, topk_quant
    counters = {"agg": fedavg_agg.LAUNCHES, "mix": fedavg_agg.LAUNCHES,
                "encode": topk_quant.LAUNCHES, "decode": topk_quant.LAUNCHES}
    kw = dict(cfg=MNIST_CNN, model="mlp", het="strong", seed=0)
    setup = make_setup(TABLE_4_2["mnist_even"], **kw, device=dev)
    n_params = sum(p.numel() for p in setup.weights0.values())
    print(f"main path: {len(setup.profiles)} workers, MLP "
          f"{tuple(setup.weights0['w1'].shape)} + "
          f"{tuple(setup.weights0['w2'].shape)}, {n_params} parameters")
    if n_params != 101_770:
        raise AssertionError(f"expected 101,770 MLP parameters, got "
                             f"{n_params}")
    weights0 = {k: v.cpu().numpy() for k, v in setup.weights0.items()}
    for tname, tkw in TRANSPORTS.items():
        for mname, mkw in MODES.items():
            key = f"{tname}/{mname}"
            for c in counters.values():
                for k in c:
                    c[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = run_fl(setup, epochs_per_round=EPOCHS, max_rounds=ROUNDS,
                       **mkw, **tkw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: counters[k][k] for k in counters}
            rounds = h[-1].version
            report[key] = {"history": [vars(p) for p in h],
                           "launches": launches, "wall_s": wall,
                           "s_per_round": wall / max(rounds, 1)}
            print(f"run {key}: {rounds} rounds, final accuracy "
                  f"{h[-1].accuracy:.4f}, {wall / max(rounds, 1):.4f} s per "
                  f"round, launches {launches}")
            if rounds != ROUNDS:
                raise AssertionError(f"{key}: {rounds} rounds, not {ROUNDS}")
            if not all(np.isfinite(p.accuracy) for p in h):
                raise AssertionError(f"{key}: non-finite accuracy")
    for name, (ctr, runs) in REQUIRED.items():
        for key in runs:
            if report[key]["launches"][ctr] < 1:
                raise AssertionError(f"{name} never launched in {key}")
        records[name]["launches"] = sum(r["launches"][ctr]
                                        for r in report.values())
    final = report["raw/sync"]["history"][-1]["accuracy"]
    if final < 0.50:
        raise AssertionError(f"raw/sync final accuracy {final} < 0.50")

    # the raw runs again on the CPU, from the same initial weights
    cpu = make_setup(TABLE_4_2["mnist_even"], **kw, weights0=weights0,
                     device="cpu")
    for mname, mkw in MODES.items():
        key = f"raw/{mname}"
        h = run_fl(cpu, epochs_per_round=EPOCHS, max_rounds=ROUNDS, **mkw,
                   **TRANSPORTS["raw"])
        gpu = report[key]["history"]
        if len(gpu) != len(h):
            raise AssertionError(f"{key}: {len(gpu)} points on the card, "
                                 f"{len(h)} on the CPU")
        for g, c in zip(gpu, h):
            for f in ("time", "version", "n_updates", "selected",
                      "up_bytes", "down_bytes"):
                if g[f] != getattr(c, f):
                    raise AssertionError(f"{key}: {f} {g[f]} on the card, "
                                         f"{getattr(c, f)} on the CPU")
        a_gpu = np.array([g["accuracy"] for g in gpu])
        a_cpu = np.array([c.accuracy for c in h])
        point = float(np.abs(a_gpu - a_cpu).max())
        last5 = float(abs(a_gpu[-5:].mean() - a_cpu[-5:].mean()))
        report[key]["cpu_accuracy"] = a_cpu.tolist()
        report[key]["cpu_gap_point"] = point
        report[key]["cpu_gap_last5"] = last5
        print(f"cpu {key}: history fields equal; accuracy gap {point:.4f} "
              f"at worst point, {last5:.4f} in the last-5 mean")
        if point > POINT_GAP or last5 > LAST5_GAP:
            raise AssertionError(f"{key}: card vs CPU accuracy gap {point} "
                                 f"(limit {POINT_GAP}), last-5 mean "
                                 f"{last5} (limit {LAST5_GAP})")


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
        run_main_path(dev, records, runs)
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
