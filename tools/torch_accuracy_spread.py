"""How far apart two runs of the port's main path drift when their
initial weights differ by one ulp in one element, on the CPU.

    PYTHONPATH=src python tools/torch_accuracy_spread.py [--perturbations 5]

Runs the main-path configuration of ``chip_smoke.py`` (TABLE_4_2 mnist_even,
MNIST width, het strong, 10 local epochs, 20 rounds, raw transport) in the
sync and time_based modes, once as it is and once per perturbation, and
prints per perturbation the largest per-point accuracy gap, the gap of the
mean of the last five points, and whether every non-accuracy history field
stayed equal.  This spread is what any two numerically different but
correct implementations (the card and the CPU) may differ by: it sets the
accuracy tolerance of chip_smoke.py's card-versus-CPU check.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.core import TABLE_4_2, make_setup, run_fl  # noqa: E402

MODES = {"sync": dict(mode="sync"),
         "time_based": dict(mode="sync", selector="time_based",
                            selector_kw={"r": 10, "T0": 0.0, "A": 0.01})}
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--perturbations", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kw = dict(cfg=MNIST_CNN, model="mlp", het="strong", seed=0,
              device="cpu")
    base = make_setup(TABLE_4_2["mnist_even"], **kw)
    w0 = {k: v.numpy().copy() for k, v in base.weights0.items()}
    rng = np.random.RandomState(args.seed)
    worst_point = worst_last5 = 0.0
    for mname, mkw in MODES.items():
        h0 = run_fl(base, epochs_per_round=10, max_rounds=20, **mkw)
        a0 = np.array([p.accuracy for p in h0])
        for j in range(args.perturbations):
            w1 = {k: v.copy() for k, v in w0.items()}
            i = rng.randint(w1["w1"].size)
            w1["w1"].flat[i] = np.nextafter(w1["w1"].flat[i],
                                            np.float32(1))
            s1 = make_setup(TABLE_4_2["mnist_even"], **kw, weights0=w1)
            h1 = run_fl(s1, epochs_per_round=10, max_rounds=20, **mkw)
            a1 = np.array([p.accuracy for p in h1])
            point = float(np.abs(a0 - a1).max())
            last5 = float(abs(a0[-5:].mean() - a1[-5:].mean()))
            same = all(getattr(p, f) == getattr(q, f)
                       for p, q in zip(h0, h1) for f in FIELDS)
            worst_point, worst_last5 = (max(worst_point, point),
                                        max(worst_last5, last5))
            print(f"{mname} w1[{i}] +1 ulp: per-point gap {point:.4f}, "
                  f"last-5 mean gap {last5:.4f}, other fields equal {same}")
    print(f"largest per-point gap {worst_point:.4f}, largest last-5 mean "
          f"gap {worst_last5:.4f}")


if __name__ == "__main__":
    main()
