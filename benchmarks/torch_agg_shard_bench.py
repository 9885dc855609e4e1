"""The port's sharded aggregation-server benchmark (the twin of
``benchmarks/agg_shard_bench.py``): merge latency and per-shard live
bytes of the (W, N) substrate against the server-mesh size.

Grid: W in {8, 64, 256} worker updates per merge x two model sizes
(``mlp_1m``, 1.07M parameters, and ``mlp_16m``, 16.8M) x mesh sizes
{1, 2, 4}, as the reference's.  One cell is ``FlatServerState(mesh=)
.merge_rows`` of W packed updates at alpha 0.5: the rows landed in their
shards, one B1 launch per shard (B7), the gather and the unpack; its time
is the host's wall clock over ``ROUNDS`` merges after two warm-up merges,
with the device synchronized before and after.  Cells whose whole
(W, N) buffer would exceed the cap (``REPRO_BENCH_MEM``, default 1.6 GB,
as the reference's) are recorded as skipped.

On the card a mesh of D > 1 with fewer cards than D repeats the card
(``agg_mesh(devices=...)``): every shard is then a separate buffer on one
card, so the per-shard bytes shrink as on D cards but the merge's time is
that of D launches on one card.  On the CPU the mesh repeats the CPU
device (``REPRO_HOST_DEVICES``, set to 4 when this runs standalone).

    REPRO_BENCH_MEM=40e9 PYTHONPATH=src python benchmarks/torch_agg_shard_bench.py   # on the H100
    PYTHONPATH=src python benchmarks/torch_agg_shard_bench.py --smoke   # CPU

It runs on the card and exits when there is none, unless the CPU is asked
for (``--device cpu``, or ``--smoke``, whose default device is the CPU).

Writes ``benchmarks/results/torch/BENCH_agg_shard.json`` with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import card_name, device_or_exit  # noqa: E402

RESULTS = Path(__file__).resolve().parent / "results" / "torch"

ALPHA = 0.5
ROUNDS = 5
UNIQUE_VECS = 16         # distinct update vectors cycled across W rows
MEM_CAP = int(float(os.environ.get("REPRO_BENCH_MEM", 1.6e9)))

MODELS = {
    # agg_bench's ~1.07M-param ragged MLP regime
    "mlp_1m": {"w1": (784, 1024), "b1": (1024,), "w2": (1024, 256),
               "b2": (256,), "w3": (256, 10), "b3": (10,)},
    # ~16.8M params: the "big" tier
    "mlp_16m": {"w1": (2048, 4096), "w2": (4096, 2048)},
}
W_GRID = (8, 64, 256)
MESH_GRID = (1, 2, 4)


def _model(spec: dict, seed: int, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn(shape, generator=g, device=device) * 0.05
            for name, shape in spec.items()}


def _mesh(d: int, device):
    """d devices of the platform, or the one device repeated when there
    are fewer."""
    import torch
    from repro_torch.parallel import sharding as psh
    n = torch.cuda.device_count() if device.type == "cuda" else \
        int(os.environ.get("REPRO_HOST_DEVICES") or 1)
    if d <= n:
        return psh.agg_mesh(d, platform=device.type)
    return psh.agg_mesh(devices=(device,) * d)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_cell(name: str, spec: dict, W: int, d: int, rounds: int,
                device) -> dict:
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fedavg_agg

    mesh = _mesh(d, device)
    template = _model(spec, 0, device)
    st = flatbuf.FlatServerState(template, mesh=mesh)
    b = st.bundle
    vecs = [b.pack(_model(spec, 1 + i, device))
            for i in range(min(W, UNIQUE_VECS))]
    updates = [vecs[i % len(vecs)] for i in range(W)]
    ws = [1.0 / (1 + (i % 3)) for i in range(W)]

    def step(server):
        return st.merge_rows(server, updates, ws, ALPHA)

    server = step(step(template))                 # warm-up: allocate
    _sync(device)
    # each shard's B1 launch counts in the kernel's own counter
    n0 = fedavg_agg.LAUNCHES["mix"]
    t0 = time.perf_counter()
    for _ in range(rounds):
        server = step(server)
    _sync(device)
    ms = (time.perf_counter() - t0) / rounds * 1e3
    launches = fedavg_agg.LAUNCHES["mix"] - n0
    rows = st._rows.shards
    mirror = st._server_flat.shards
    cell = {
        "model": name, "n_params": b.n_params, "W": W, "mesh": d,
        "mesh_devices": [str(x) for x in mesh.devices],
        "merge_ms": ms,
        "b1_launches_per_merge": launches / rounds,
        "row_buffer_bytes_per_device": max(p.numel() * 4 for p in rows),
        "server_buffer_bytes_per_device": max(p.numel() * 4
                                              for p in mirror),
        "row_buffer_bytes_total": int(W * b.padded_size * 4),
    }
    del st, vecs, updates, server
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    return cell


def run(device, smoke: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import flatbuf

    models = {"mlp_1m": MODELS["mlp_1m"]} if smoke else MODELS
    w_grid = (8,) if smoke else W_GRID
    rounds = 3 if smoke else ROUNDS
    cells, skipped = [], []
    for name, spec in models.items():
        n_params = sum(int(np.prod(s)) for s in spec.values())
        for W in w_grid:
            for d in MESH_GRID:
                full = W * flatbuf.padded_size_for(n_params, d) * 4
                if full > MEM_CAP:
                    skipped.append({"model": name, "W": W, "mesh": d,
                                    "reason": f"(W,N) buffer {full:.2e} B "
                                              f"> cap {MEM_CAP:.2e}"})
                    continue
                cells.append(_bench_cell(name, spec, W, d, rounds, device))
    rec = {
        "config": {"alpha": ALPHA, "rounds": rounds, "smoke": smoke,
                   "device": str(device), "card": card_name(),
                   "mem_cap": MEM_CAP, "torch": torch.__version__},
        "cells": cells,
        "skipped": skipped,
    }
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "BENCH_agg_shard.json").write_text(json.dumps(rec, indent=2))
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one model, W = 8, 3 merges (default device: cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (cpu with --smoke)")
    args = ap.parse_args(argv)
    if args.device is None:
        args.device = "cpu" if args.smoke else "cuda"
    return args


def main() -> None:
    args = parse_args()
    smoke = args.smoke
    rec = run(device_or_exit(args.device), smoke=smoke)
    print("== Sharded aggregation (port): merge ms / per-shard live bytes "
          "vs mesh size ==")
    print(f"device={rec['config']['device']} card={rec['config']['card']} "
          f"smoke={smoke}")
    print("model,n_params,W,mesh,merge_ms,row_MB_per_shard")
    for c in rec["cells"]:
        print(f"{c['model']},{c['n_params']},{c['W']},{c['mesh']},"
              f"{c['merge_ms']:.4f},"
              f"{c['row_buffer_bytes_per_device'] / 1e6:.2f}")
    for s in rec["skipped"]:
        print(f"skipped {s['model']} W={s['W']} mesh={s['mesh']}: "
              f"{s['reason']}")


if __name__ == "__main__":
    os.environ.setdefault("REPRO_HOST_DEVICES", "4")
    main()
