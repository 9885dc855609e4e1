"""The port's massive-scale worker-simulation benchmark (the twin of
``benchmarks/scale_bench.py``): the control plane against the worker
population size.

Sweeps W from 10 to 10,000 with a FIXED cohort (64 workers sampled a
round) and measures what bounds scale:

  * wall-clock rounds/s — per-round cost must track the cohort, not W
    (the reference's bar: W = 10,000 with a 64-cohort at >= 0.5x the
    rounds/s of a PLAIN 64-worker population);
  * row-buffer capacity and bytes — the merge window must stay
    O(cohort x N), never O(W x N);
  * resident links — LRU-bounded, O(active cohorts) — and evictions;
  * the per-object footprint of the hot control-plane classes
    (``transport.Payload``, ``transport.Link``, ``events._Event``,
    ``worker.FLWorker``) against dict-based twins.

    PYTHONPATH=src python benchmarks/torch_scale_bench.py          # on the H100
    PYTHONPATH=src python benchmarks/torch_scale_bench.py --smoke --device cpu

It runs on the card and exits when there is none, unless the CPU is asked
for.  Writes ``benchmarks/results/torch/BENCH_scale.json`` (never the
reference's file) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import card_name, device_or_exit  # noqa: E402

RESULTS = Path(__file__).resolve().parent / "results" / "torch"

COHORT = 64
ROUNDS = 5
EPOCHS = 1
SWEEP_W = (10, 100, 1_000, 10_000)
SMOKE_W = (10, 200)
SMOKE_COHORT = 8
SMOKE_ROUNDS = 2


def _setup_for(W: int, device, seed: int = 0):
    """One tiny MLP shard replicated across W workers: every worker
    trains the same single batch, so per-round numerics cost is constant
    and the sweep isolates the CONTROL-PLANE cost of W."""
    from repro_torch.core.experiment import heterogeneous_profiles, make_setup
    base = make_setup([1], model="mlp", seed=seed, device=device)
    return dataclasses.replace(
        base,
        shards=[base.shards[0]] * W,
        device_shards=[base.device_shards[0]] * W,
        profiles=heterogeneous_profiles(W, "mixed", [1] * W, seed=seed))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_one(W: int, cohort, rounds: int, device, seed: int = 0) -> dict:
    """One measured run, built inline (as ``run_fl`` builds it) so the
    post-run internals — row-buffer capacity, resident links, eviction
    and event-heap counters — can be read."""
    from repro_torch.core.estimator import TimeEstimator
    from repro_torch.core.events import EventLoop
    from repro_torch.core.population import WorkerPopulation
    from repro_torch.core.selection import make_selector
    from repro_torch.core.server import AggregationServer
    from repro_torch.core.transport import Transport
    from repro_torch.core.worker import FLWorker

    setup = _setup_for(W, device, seed)
    loop = EventLoop()
    est = TimeEstimator(t_onebatch_server=setup.per_batch_server)
    pop = WorkerPopulation()
    est.bind_population(pop)
    tr = Transport(setup.weights0, codec="raw",
                   raw_bytes=setup.model_bytes)
    sel = make_selector("all", est, tr.expected_oneway_bytes)
    server = AggregationServer(
        weights=setup.weights0, loop=loop, estimator=est, selector=sel,
        eval_fn=setup.eval_fn, model_bytes=setup.model_bytes,
        mode="sync", epochs_per_round=EPOCHS, max_rounds=rounds,
        transport=tr, population=pop, cohort=cohort)
    t_build0 = time.perf_counter()
    for prof, shard in zip(setup.profiles, setup.device_shards):
        server.add_worker(FLWorker(
            prof.worker_id, profile=prof, data=shard,
            train_fn=setup.train_fn, loop=loop,
            per_batch_time=0.05 * 3.0 / (prof.cpu_freq * prof.cpu_prop)))
    build_s = time.perf_counter() - t_build0
    server.start()
    _sync(setup.device)
    t0 = time.perf_counter()
    loop.run(max_events=100_000_000)
    _sync(setup.device)
    wall = time.perf_counter() - t0
    flat = server._flat
    n_rounds = server.version
    return {
        "W": W,
        "cohort": cohort,
        "sim_rounds": n_rounds,
        "build_s": build_s,
        "wall_s": wall,
        "rounds_per_s": n_rounds / max(wall, 1e-9),
        "row_buffer_capacity": flat.capacity,
        "row_buffer_bytes": flat.capacity * flat.bundle.padded_size * 4,
        "resident_links": len(tr._links),
        "link_evictions": tr.total_link_evictions,
        "final_accuracy": server.history[-1].accuracy,
        "event_heap_left": len(loop._q),
    }


def _slots_report() -> dict:
    """Per-object footprint of the slotted hot classes vs dict twins."""
    import torch

    from repro_torch.core import events, transport
    from repro_torch.core.estimator import WorkerProfile
    from repro_torch.core.events import EventLoop
    from repro_torch.core.worker import FLWorker

    def size(obj) -> int:
        n = sys.getsizeof(obj)
        d = getattr(obj, "__dict__", None)
        if d:
            n += sys.getsizeof(d)
        return n

    class DictPayload:
        def __init__(self, codec, wire_bytes, data):
            self.codec, self.wire_bytes, self.data = codec, wire_bytes, data

    class DictEvent:
        def __init__(self, time, seq, fn, args=(), cancelled=False):
            self.time, self.seq, self.fn = time, seq, fn
            self.args, self.cancelled = args, cancelled

    def dict_twin(slots):
        class DictTwin:
            def __init__(self):
                for k in slots:
                    if not k.startswith("__"):     # Link's lazy __dict__
                        setattr(self, k, None)
        return DictTwin()

    tr = transport.Transport({"w": torch.zeros(4)}, codec="raw",
                             raw_bytes=16)
    link = tr.link("w0")
    payload = transport.Payload("raw", 16, None)
    ev = events._Event(0.0, 0, lambda: None)
    w = FLWorker("w", profile=WorkerProfile("w"), data={},
                 train_fn=None, loop=EventLoop(), per_batch_time=1.0)
    return {
        "payload_bytes": {"slotted": size(payload),
                          "dict": size(DictPayload("raw", 16, None))},
        "event_bytes": {"slotted": size(ev),
                        "dict": size(DictEvent(0.0, 0, lambda: None))},
        "link_bytes": {"slotted": size(link),
                       "dict": size(dict_twin(transport.Link.__slots__))},
        "flworker_bytes": {"slotted": size(w),
                           "dict": size(dict_twin(FLWorker.__slots__))},
    }


def run(device, smoke: bool = False) -> dict:
    import torch
    ws = SMOKE_W if smoke else SWEEP_W
    cohort = SMOKE_COHORT if smoke else COHORT
    rounds = SMOKE_ROUNDS if smoke else ROUNDS
    sweep = []
    for W in ws:
        r = _run_one(W, min(cohort, W), rounds, device)
        sweep.append(r)
        print(f"W={W:>6} cohort={r['cohort']:>3} "
              f"{r['rounds_per_s']:>8.2f} rounds/s  "
              f"rowbuf={r['row_buffer_bytes']:>10d}B "
              f"links={r['resident_links']:>4d} "
              f"evict={r['link_evictions']}", file=sys.stderr)
    plain = _run_one(cohort, None, rounds, device)
    print(f"W={cohort:>6} (no cohort) {plain['rounds_per_s']:>8.2f} "
          f"rounds/s", file=sys.stderr)
    biggest = sweep[-1]
    return {
        "config": {"cohort": cohort, "rounds": rounds, "epochs": EPOCHS,
                   "smoke": smoke, "device": str(device), "card": card_name(),
                   "torch": torch.__version__},
        "sweep": sweep,
        "plain_cohort_sized": plain,
        "acceptance": {
            "big_W_vs_plain_ratio":
                biggest["rounds_per_s"] / max(plain["rounds_per_s"], 1e-9),
            "row_buffer_capacity_le_2x_cohort":
                biggest["row_buffer_capacity"] <= 2 * cohort,
            "resident_links_bounded":
                biggest["resident_links"] <= max(4 * cohort, 64),
        },
        "slots": _slots_report(),
    }


def main(smoke: bool = False, device=None, results=None) -> None:
    """``device`` None: the card (``--device`` on the command line)."""
    from repro_torch import resolve_device
    out = run(resolve_device(device), smoke=smoke)
    path = Path(results) if results is not None else RESULTS
    path.mkdir(parents=True, exist_ok=True)
    (path / "BENCH_scale.json").write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--results", default=None,
                    help="write under this directory instead")
    args = ap.parse_args()
    main(smoke=args.smoke, device=device_or_exit(args.device),
         results=args.results)
