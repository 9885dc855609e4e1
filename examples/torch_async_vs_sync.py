"""Sequential vs sync-FL vs async-FL on the port (thesis figs 4.6/4.7):
accuracy over simulated time under heterogeneous workers, with the
Algorithm-2 selector.  The twin of ``examples/async_vs_sync.py`` through
``repro_torch``; it runs on the CUDA card, and on the CPU when asked.

    PYTHONPATH=src python examples/torch_async_vs_sync.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (TABLE_4_1, make_setup, run_fl,
                              run_sequential_baseline, time_to_accuracy)


def sparkline(history, t_max, width=60):
    cells = [" "] * width
    for p in history:
        i = min(width - 1, int(p.time / t_max * width))
        lvl = "▁▂▃▄▅▆▇█"[min(7, int(p.accuracy * 8))]
        cells[i] = lvl
    return "".join(cells)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.2,
                       batch_size=64, het="extreme", device=args.device)
    alg2 = {"r": 10, "T0": 0.0, "A": 0.01}
    seq = run_sequential_baseline(setup, epochs_per_round=10, max_rounds=60)
    sync = run_fl(setup, mode="sync", selector="time_based",
                  epochs_per_round=10, max_rounds=300, selector_kw=alg2)
    asyn = run_fl(setup, mode="async", selector="time_based",
                  aggregator="linear", epochs_per_round=10, max_rounds=900,
                  selector_kw=alg2, async_latest_table=False,
                  async_alpha=0.9, async_stale_pow=0.25)
    t_max = 30.0
    print("accuracy over simulated time (0..%.0fs):" % t_max)
    for name, h in [("sequential", seq), ("sync+alg2 ", sync),
                    ("async+alg2", asyn)]:
        t80 = time_to_accuracy(h, 0.8)
        print(f"{name} |{sparkline(h, t_max)}| t80={t80:.2f}s")
    s, y, a = (time_to_accuracy(h, 0.8) for h in (seq, sync, asyn))
    print(f"\nsync+alg2 is {100*(1-y/s):.1f}% faster than sequential to 80%")
    print(f"async+alg2 is {100*(1-a/y):.1f}% faster than sync to 80%")


if __name__ == "__main__":
    main()
