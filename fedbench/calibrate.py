"""Readings from which the limits of ``correct`` are set (not run by the
benchmark's own runs).

    python fedbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control] [--faults half_batch,altered,...]

For each seed: the program's checked steps against the reference (the
sound reading); with ``--control`` the reference computed in the precision
below the configuration's (TF32 for float32, fp8 for bfloat16) against the
reference; with ``--faults`` the program with each fault planted against
the reference.  One JSON line a reading, also appended to
``chiprun_out/calibrate.jsonl``.  On the card only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Iterator, Sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fedbench import harness  # noqa: E402


def readings(cell: harness.Cell, seeds: Sequence[int], *, control: bool,
             faults: Sequence[str], here: Path = harness.HERE
             ) -> Iterator[dict]:
    """(seed, kind, {number: value}, seconds) for each reading, on
    ``cell.device``."""
    import torch
    mod = harness.driver(cell, here)

    def program(fault=None):
        drv = mod.Driver(cell, fault=fault)
        drv.setup()
        drv.release()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        return drv

    def values(checks):
        return {c["name"]: c["value"] for c in checks}

    for seed in seeds:
        cell.seed = seed
        t0 = time.perf_counter()
        drv = program()
        ref = drv.reference()
        yield seed, "sound", values(drv.compare(drv.prog, ref)), \
            time.perf_counter() - t0
        if control:
            t0 = time.perf_counter()
            low = drv.as_program(drv.reference(lower=True))
            yield seed, "control", values(drv.compare(low, ref)), \
                time.perf_counter() - t0
        for fault in faults:
            t0 = time.perf_counter()
            bad = program(fault)
            yield seed, f"fault:{fault}", values(bad.compare(bad.prog, ref)), \
                time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA card")
    from repro_torch import resolve_device
    cell = harness.find_cell(args.workload)
    cell.device = resolve_device("cuda")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    card = harness.card_line()
    print(f"calibrate: {card}; torch {torch.__version__}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for seed, kind, vals, sec in readings(cell, seeds, control=args.control,
                                          faults=faults):
        line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                           "values": vals, "s": round(sec, 2), "card": card})
        print(line, flush=True)
        with open(out / "calibrate.jsonl", "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
