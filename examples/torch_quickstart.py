"""Quickstart on the port: federated learning with worker selection.

The twin of ``examples/quickstart.py`` through ``repro_torch``: the
thesis' 10-worker setup (even data split, heterogeneous worker profiles),
synchronous FL with the training-time-based selector (Algorithm 2), and
accuracy over simulated time.  It runs on the CUDA card, and on the CPU
when asked (``--device cpu``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TABLE_4_1, make_setup, run_fl, time_to_accuracy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.2,
                       batch_size=64, het="extreme", device=args.device)
    print(f"10 workers, {setup.model_bytes/1e3:.0f} KB model on "
          f"{setup.device}, profiles: "
          f"{[round(p.cpu_freq * p.cpu_prop, 2) for p in setup.profiles]}"
          " effective GHz")
    history = run_fl(setup, mode="sync", selector="time_based",
                     epochs_per_round=10, max_rounds=120,
                     selector_kw={"r": 10, "T0": 0.0, "A": 0.01})
    print(f"\n{'sim time':>9} {'round':>6} {'accuracy':>9} {'#updates':>9}")
    for p in history[::6]:
        print(f"{p.time:>9.2f} {p.version:>6} {p.accuracy:>9.3f} "
              f"{p.n_updates:>9}")
    t80 = time_to_accuracy(history, 0.8)
    print(f"\nreached 80% accuracy at simulated t={t80:.2f}s "
          f"(final {history[-1].accuracy:.3f})")


if __name__ == "__main__":
    main()
