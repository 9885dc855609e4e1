"""Fault tolerance + elastic scaling on the port: kill two workers
mid-training, let one recover, add a brand-new worker — training carries
on and the selection policy routes around the failures.  The twin of
``examples/fault_tolerance_demo.py`` through ``repro_torch``; it runs on
the CUDA card, and on the CPU when asked.

    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TABLE_4_1, make_setup
from repro_torch.core.estimator import TimeEstimator, WorkerProfile
from repro_torch.core.events import EventLoop
from repro_torch.core.selection import make_selector
from repro_torch.core.server import AggregationServer
from repro_torch.core.worker import FLWorker
from repro_torch.runtime import ElasticPool, FaultInjector


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.2,
                       batch_size=64, het="extreme", device=args.device)
    loop = EventLoop()
    est = TimeEstimator(server_freq=3.0, t_onebatch_server=setup.per_batch_server)
    sel = make_selector("time_based", est, setup.model_bytes, r=10, T0=0.0, A=0.01)
    server = AggregationServer(
        weights=setup.weights0, loop=loop, estimator=est, selector=sel,
        eval_fn=setup.eval_fn, model_bytes=setup.model_bytes, mode="sync",
        epochs_per_round=10, max_rounds=60)
    for prof, shard in zip(setup.profiles, setup.device_shards):
        server.add_worker(FLWorker(prof.worker_id, profile=prof, data=shard,
                                   train_fn=setup.train_fn, loop=loop))

    faults = FaultInjector(loop, server)
    pool = ElasticPool(loop, server)
    faults.kill_at(1.0, "w0")          # fastest worker dies mid-round
    faults.kill_at(1.0, "w3")
    faults.recover_at(6.0, "w0")       # w0 comes back
    late = FLWorker("w_new", profile=WorkerProfile(
        "w_new", cpu_freq=3.0, cpu_prop=1.0, bandwidth=2e8, n_batches=1),
        data=setup.device_shards[3], train_fn=setup.train_fn, loop=loop)
    pool.join_at(4.0, late)            # elastic scale-up

    print("events: kill w0,w3 @t=1.0; join w_new @t=4.0; recover w0 @t=6.0")
    server.start()
    loop.run(max_events=100_000)
    for p in server.history[::5]:
        print(f"t={p.time:7.2f} round={p.version:3d} acc={p.accuracy:.3f} "
              f"updates={p.n_updates}")
    print(f"\nfinal accuracy {server.history[-1].accuracy:.3f} "
          f"(w0 failed={server.workers['w0'].profile.failed}, "
          f"w_new registered={'w_new' in server.workers})")


if __name__ == "__main__":
    main()
