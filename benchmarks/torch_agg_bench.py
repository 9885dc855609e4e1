"""The port's aggregation-server merge microbenchmark (the twin of
``benchmarks/agg_bench.py``): the flat-buffer fused merge against a
per-leaf tree-map merge.

Config as the reference's: a ~1.07M-parameter MLP with ragged leaf
shapes, W = 8 worker updates per merge, alpha 0.5 (the server mix).  Both
paths run as the server drives them: worker responses arrive as dicts of
tensors; the baseline takes the weighted mean leaf by leaf (W reads and
W - 1 adds a leaf, the reference's ``aggregation._weighted_mean``) and
then ``aggregation.mix_into``; the fused path packs into the persistent
(W, N) row buffer and merges in one launch of B1
(``FlatServerState.merge``).  Each path's time is the host's wall clock
over ``ROUNDS`` merges after two warm-up merges, with the device
synchronized before and after; the two results are held against each
other (a benchmark of wrong numbers is worthless).

    PYTHONPATH=src python benchmarks/torch_agg_bench.py              # on the H100
    PYTHONPATH=src python benchmarks/torch_agg_bench.py --device cpu

It runs on the card and exits when there is none, unless the CPU is asked
for.  Writes ``benchmarks/results/torch/BENCH_agg.json`` (never the
reference's file) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import card_name, device_or_exit  # noqa: E402

RESULTS = Path(__file__).resolve().parent / "results" / "torch"

W = 8              # worker updates per merge
ALPHA = 0.5        # server damping (exercises the fused mix term)
ROUNDS = 30        # timed merges per path
HIDDEN = 1024      # ~1.07M params total
SHAPES = {"w1": (784, HIDDEN), "b1": (HIDDEN,), "w2": (HIDDEN, 256),
          "b2": (256,), "w3": (256, 10), "b3": (10,)}


def _model(seed: int, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(s, generator=g, device=device) * 0.05
            for k, s in SHAPES.items()}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_path(step, server, device) -> float:
    """Wall seconds per merge, after two warm-up merges."""
    s = step(step(server))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        s = step(s)
    _sync(device)
    return (time.perf_counter() - t0) / ROUNDS


def treemap_mean(trees, weights):
    """The per-leaf weighted mean: W reads and W - 1 adds a leaf."""
    import torch
    from repro_torch.core import flatbuf
    w = flatbuf.normalized_weights(weights)
    out = {}
    for k, leaf in trees[0].items():
        acc = torch.zeros_like(leaf, dtype=torch.float32)
        for wi, t in zip(w, trees):
            acc = acc + float(wi) * t[k].to(torch.float32)
        out[k] = acc.to(leaf.dtype)
    return out


def run(device) -> dict:
    import torch
    from repro_torch import resolve_device
    from repro_torch.core import aggregation as agg
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fedavg_agg

    device = resolve_device(device)
    server0 = _model(0, device)
    updates = [_model(1 + i, device) for i in range(W)]
    ws = [1.0 / (1 + (i % 3)) for i in range(W)]       # staleness-ish weights
    n_params = sum(t.numel() for t in server0.values())

    def baseline_step(server):
        return agg.mix_into(server, treemap_mean(updates, ws), ALPHA)

    flat_state = flatbuf.FlatServerState(server0)

    def fused_step(server):
        return flat_state.merge(server, updates, ws, ALPHA)

    t_base = _time_path(baseline_step, server0, device)
    n0 = fedavg_agg.LAUNCHES["mix"]
    t_fused = _time_path(fused_step, server0, device)
    b1 = (fedavg_agg.LAUNCHES["mix"] - n0) / (ROUNDS + 2)

    a = baseline_step(server0)
    b = fused_step(server0)
    max_err = max(float((a[k] - b[k]).abs().max()) for k in a)

    rec = {
        "config": {"W": W, "n_params": int(n_params), "alpha": ALPHA,
                   "rounds": ROUNDS, "device": str(device),
                   "card": card_name(), "torch": torch.__version__},
        "treemap_baseline_ms": t_base * 1e3,
        "flat_fused_ms": t_fused * 1e3,
        "speedup": t_base / t_fused,
        "b1_launches_per_merge": b1,
        "max_abs_err": max_err,
    }
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "BENCH_agg.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    rec = run(device_or_exit(args.device))
    cfg = rec["config"]
    print("== Aggregation merge (port): flat fused vs per-leaf tree-map ==")
    print(f"W={cfg['W']} n_params={cfg['n_params']} alpha={cfg['alpha']} "
          f"device={cfg['device']} card={cfg['card']}")
    print(f"tree-map baseline: {rec['treemap_baseline_ms']:.4f} ms/merge")
    print(f"flat fused path:   {rec['flat_fused_ms']:.4f} ms/merge "
          f"({rec['b1_launches_per_merge']:g} B1 launches a merge)")
    print(f"speedup:           {rec['speedup']:.2f}x  "
          f"(max |err| {rec['max_abs_err']:.2e})")


if __name__ == "__main__":
    main()
