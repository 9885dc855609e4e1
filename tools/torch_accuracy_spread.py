"""How far apart two runs of the port drift when their initial weights
differ by one ulp in one element, on the CPU.

    PYTHONPATH=src python tools/torch_accuracy_spread.py [--phase main]
        [--perturbations 5]
    PYTHONPATH=src python tools/torch_accuracy_spread.py --phase paper \
        --perturbations 10

Runs the card-versus-CPU-compared runs of one phase of ``chip_smoke.py``
(``main``: the four raw runs of the 30-worker main path, 20 rounds;
``hetero``: the Dirichlet alpha 0.3 server-optimizer and FedProx runs;
``cnn``: the thesis CNN under FedAvg and FedAdam) once as they are and
once per perturbation, and prints per perturbation the largest per-point
accuracy gap, the gap of the mean of the last five points, and whether
every non-accuracy history field stayed equal; then the largest of each
per run.  This spread is what any
two numerically different but correct implementations (the card and the
CPU) may differ by: it sets ``SPREAD`` and so the accuracy bounds of
chip_smoke.py's card-versus-CPU check.

``--phase paper`` runs phase 12's runs (``chip_smoke.PAPER`` but the
control, each up to 0.8 accuracy from the fixture's initial weights) and
prints, per perturbation of the fixture's ``w1``, how far t80 moved, the
largest per-point accuracy gap on the histories' common prefix and
whether every non-accuracy field stayed equal there; then the largest of
each per run, which set ``T80_SPREAD`` and ``ACC_SPREAD`` and so
``T80_GAPS`` and ``ACC_GAPS``.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402

PERTURB = {"mlp": "w1", "cnn": "c2w"}     # the weight that gets the ulp


def _setup(spec, weights0=None):
    table, kw = chip_smoke.PHASES[spec["phase"]]
    return core.make_setup(getattr(core, table)["mnist_even"], cfg=MNIST_CNN,
                           model=spec["model"], seed=0, **kw,
                           **spec["setup_kw"], weights0=weights0,
                           device="cpu")


def _run(setup, spec):
    return core.run_fl(setup, epochs_per_round=chip_smoke.EPOCHS,
                       max_rounds=spec["rounds"], **spec["run_kw"])


def _perturbed(w0, name, rng):
    """``w0`` with one element of ``name`` one ulp up: (copy, index)."""
    w1 = {k: v.copy() for k, v in w0.items()}
    i = rng.randint(w1[name].size)
    w1[name].flat[i] = np.nextafter(w1[name].flat[i], np.float32(1))
    return w1, i


def paper_spread(perturbations, rng):
    from repro_torch.core import time_to_accuracy
    w0 = chip_smoke.paper_weights0()
    control = chip_smoke.PAPER_CONTROL[0]
    for key in [k for k in chip_smoke.PAPER if k != control]:
        h0 = chip_smoke.paper_call(key, chip_smoke.paper_setup(key, "cpu",
                                                               w0))
        t0 = time_to_accuracy(h0, chip_smoke.PAPER_TARGET)
        worst = np.zeros(2)
        for _ in range(perturbations):
            w1, i = _perturbed(w0, "w1", rng)
            h1 = chip_smoke.paper_call(key, chip_smoke.paper_setup(
                key, "cpu", w1))
            t1 = time_to_accuracy(h1, chip_smoke.PAPER_TARGET)
            move = abs(t1 - t0)
            gap = max(abs(p.accuracy - q.accuracy) for p, q in zip(h0, h1))
            same = all(getattr(p, f) == getattr(q, f)
                       for p, q in zip(h0, h1) for f in chip_smoke.FIELDS)
            worst = np.maximum(worst, (move, gap))
            print(f"{key} w1[{i}] +1 ulp: t80 {t1} against {t0}, moved "
                  f"{move:.4f}, largest accuracy gap on the common prefix "
                  f"{gap:.4f}, other fields equal there {same}", flush=True)
        print(f"{key}: largest t80 move {worst[0]:.4f}, largest accuracy "
              f"gap {worst[1]:.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=sorted(chip_smoke.PHASES) + ["paper"],
                    default="main")
    ap.add_argument("--perturbations", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.phase == "paper":
        return paper_spread(args.perturbations,
                            np.random.RandomState(args.seed))
    keys = [k for k, s in chip_smoke.RUNS.items()
            if s["phase"] == args.phase and s["compare"]]
    rng = np.random.RandomState(args.seed)
    for key in keys:
        spec = chip_smoke.RUNS[key]
        base = _setup(spec)
        w0 = {k: v.numpy().copy() for k, v in base.weights0.items()}
        h0 = _run(base, spec)
        a0 = np.array([p.accuracy for p in h0])
        name = PERTURB[spec["model"]]
        worst = np.zeros(2)
        for _ in range(args.perturbations):
            w1, i = _perturbed(w0, name, rng)
            h1 = _run(_setup(spec, w1), spec)
            a1 = np.array([p.accuracy for p in h1])
            point = float(np.abs(a0 - a1).max())
            last5 = float(abs(a0[-5:].mean() - a1[-5:].mean()))
            same = all(getattr(p, f) == getattr(q, f)
                       for p, q in zip(h0, h1) for f in chip_smoke.FIELDS)
            worst = np.maximum(worst, (point, last5))
            print(f"{key} {name}[{i}] +1 ulp: per-point gap {point:.4f}, "
                  f"last-5 mean gap {last5:.4f}, other fields equal {same}",
                  flush=True)
        print(f"{key}: largest per-point gap {worst[0]:.4f}, last-5 mean "
              f"{worst[1]:.4f}", flush=True)


if __name__ == "__main__":
    main()
