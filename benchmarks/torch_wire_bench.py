"""The port's transport-codec encode microbenchmark (the twin of
``benchmarks/wire_bench.py``): the fused flat-buffer top-k+int8 uplink
encode (one ``ef_encode`` launch over the packed f32 vector on the card)
against the per-leaf ``ErrorFeedbackCompressor`` reference (leaf-local
top-k and quantisation, its ``REPRO_AGG_PATH=tree`` branch).

Config as the reference's: a ~1.07M-parameter model of ragged leaves,
each "encode" one worker update prepared for the uplink, frac 0.1.  Each
path's time is the host's wall clock over ``ROUNDS`` encodes after two
warm-up encodes, the device synchronized before and after.  Reports
ms/encode and the exact bytes per update of every codec in the registry.

    PYTHONPATH=src python benchmarks/torch_wire_bench.py           # the H100
    PYTHONPATH=src python benchmarks/torch_wire_bench.py --smoke   # the CPU

It runs on the card and exits when there is none, unless the CPU is asked
for (``--device cpu``; ``--smoke`` defaults to the CPU and times 3
encodes).  Writes ``benchmarks/results/torch/BENCH_wire.json`` (never the
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

ROUNDS = 20        # timed encodes per path
HIDDEN = 1024      # ~1.07M params total (matches agg_bench)
FRAC = 0.1
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


def _time_encode(step, device, rounds: int) -> float:
    step(0)                             # warm-up: builds, allocator pools
    step(1)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(rounds):
        step(2 + i)
    _sync(device)
    return (time.perf_counter() - t0) / rounds


def run(device, rounds: int = ROUNDS) -> dict:
    import torch
    from repro_torch.core import transport
    from repro_torch.core.compression import ErrorFeedbackCompressor
    from repro_torch.kernels import topk_quant

    base = _model(0, device)
    news = [_model(1 + i, device) for i in range(2 + rounds)]
    n_params = sum(t.numel() for t in base.values())

    # fused flat path: pack -> one ef_encode launch
    tr = transport.Transport(base, codec="topk_ef+int8", frac=FRAC)
    link = tr.link("bench")
    link.encode_down(base)

    def fused_step(i):
        return link.encode_up(news[i % len(news)]).data

    # per-leaf reference: leaf-local top-k + per-tensor scales
    comp = ErrorFeedbackCompressor(frac=FRAC, quantize=True)
    deltas = [{k: n[k] - base[k] for k in base} for n in news]

    def tree_step(i):
        return comp._compress_tree(deltas[i % len(deltas)])[0]

    n0 = topk_quant.LAUNCHES["ef_encode"]
    t_fused = _time_encode(fused_step, device, rounds)
    launches = (topk_quant.LAUNCHES["ef_encode"] - n0) / (rounds + 2)
    t_tree = _time_encode(tree_step, device, rounds)

    bytes_per_update = {
        name: transport.Transport(base, codec=name,
                                  frac=FRAC).expected_up_bytes()
        for name in transport.CODECS}
    rec = {
        "config": {"n_params": int(n_params), "frac": FRAC,
                   "rounds": rounds, "device": str(device),
                   "card": card_name() if device.type == "cuda" else "cpu",
                   "torch": torch.__version__},
        "fused_flat_encode_ms": t_fused * 1e3,
        "per_leaf_tree_encode_ms": t_tree * 1e3,
        "speedup": t_tree / t_fused,
        "ef_encode_launches_per_encode": launches,
        "bytes_per_update": bytes_per_update,
        "uplink_ratio_vs_raw": {
            name: bytes_per_update["raw"] / b
            for name, b in bytes_per_update.items()},
    }
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "BENCH_wire.json").write_text(json.dumps(rec, indent=2))
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="3 timed encodes; on the CPU unless --device says")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    if args.device is None:
        args.device = "cpu" if args.smoke else "cuda"
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    rec = run(device_or_exit(args.device), 3 if args.smoke else ROUNDS)
    cfg = rec["config"]
    print("== Wire codec encode (port): fused flat kernel vs per-leaf "
          "tree-map ==")
    print(f"n_params={cfg['n_params']} frac={cfg['frac']} "
          f"device={cfg['device']} card={cfg['card']}")
    print(f"per-leaf tree encode: {rec['per_leaf_tree_encode_ms']:.4f} ms")
    print(f"fused flat encode:    {rec['fused_flat_encode_ms']:.4f} ms "
          f"({rec['ef_encode_launches_per_encode']:g} ef_encode launches "
          f"an encode)")
    print(f"speedup:              {rec['speedup']:.2f}x")
    print("bytes/update:", json.dumps(rec["bytes_per_update"]))
    print("vs raw:      ", json.dumps(
        {k: round(v, 2) for k, v in rec["uplink_ratio_vs_raw"].items()}))


if __name__ == "__main__":
    main()
