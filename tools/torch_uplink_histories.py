"""Run ``chip_smoke.py``'s FL runs on the card and keep their histories, or
compare two such records.

    PYTHONPATH=src python tools/torch_uplink_histories.py --out FILE
        [--runs uplink_only/sync,uplink_only/async,... | --runs opt]
    python tools/torch_uplink_histories.py --compare FILE_A FILE_B

The first form builds each run's setup on the CUDA card as
``chip_smoke.py`` does (its ``RUNS``, ``PHASES`` and ``Setups``), runs it
once, and writes to FILE, per run, the history (every ``HistoryPoint``
field, accuracy included) and the wall seconds per round (host clock
around the run, which ends in a synchronise), beside the card's name and
power limit.  By default it runs the four ``uplink_only/*`` runs;
``--runs opt`` runs the heterogeneity phase (the five server-optimizer
runs and FedProx) and the CNN's FedAdam run.  The record sets
``torch.backends.cudnn.deterministic``: without it the CNN's cuDNN
convolutions pick algorithms that sum in a run-dependent order, and its
accuracy differs between two runs of one tree on the card.  It
imports ``chip_smoke`` and ``repro_torch`` from the tree it sits in, so a
copy of it placed in another checkout measures that checkout: two trees,
run in turns in one call on one card, compare like with like.  The second
form exits non-zero unless both records hold the same runs with equal
histories in every field, and prints the seconds per round side by side.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UPLINK_RUNS = ("uplink_only/sync", "uplink_only/async",
               "uplink_only/async_delta", "uplink_only/time_based")
OPT_RUNS = ("hetero/sync/fedavgm", "hetero/sync/fedadam",
            "hetero/sync/feddyn", "hetero/sync/fedprox",
            "hetero/async/fedadam", "hetero/sync_topk/fedadam",
            "cnn/sync/fedadam")


def record(runs, out):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke
    from repro_torch.core import run_fl
    if not torch.cuda.is_available():
        raise SystemExit("torch_uplink_histories: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True
    setups = chip_smoke.Setups(dev)
    rec = {"card": card.stdout.strip(), "tree": str(ROOT),
           "cudnn_deterministic": True, "runs": {}}
    for key in runs:
        spec = chip_smoke.RUNS[key]
        setup = setups.get(spec, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_fl(setup, epochs_per_round=chip_smoke.EPOCHS,
                   max_rounds=spec["rounds"], **spec["run_kw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec["runs"][key] = {"history": [vars(p) for p in h],
                            "s_per_round": wall / max(h[-1].version, 1)}
        print(f"{key}: {rec['runs'][key]['s_per_round']:.4f} s per round, "
              f"final accuracy {h[-1].accuracy:.4f}")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(rec, indent=1))


def compare(path_a, path_b) -> int:
    a, b = (json.loads(Path(p).read_text()) for p in (path_a, path_b))
    bad = 0
    if sorted(a["runs"]) != sorted(b["runs"]):
        print(f"different runs: {sorted(a['runs'])} vs {sorted(b['runs'])}")
        return 1
    for key in a["runs"]:
        ha, hb = a["runs"][key]["history"], b["runs"][key]["history"]
        same = ha == hb
        bad += not same
        print(f"{key}: histories equal in every field: {same}; s per round "
              f"{a['runs'][key]['s_per_round']:.6f} vs "
              f"{b['runs'][key]['s_per_round']:.6f}")
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--runs", default=",".join(UPLINK_RUNS))
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare))
    if not args.out:
        ap.error("--out or --compare is required")
    record(OPT_RUNS if args.runs == "opt" else args.runs.split(","),
           args.out)


if __name__ == "__main__":
    main()
