"""What the port's tracing costs: one process builds a benchmark cell once
and runs its plain window in turns with ``repro_torch.tracing`` off and on
(off, on, on, off, a turn; no profiler), so both sides share the card, the
host and the warmed program.

    PYTHONPATH=src python tools/torch_tracing_cost.py \\
        --workload musicgen-pods.raw-h10 --seed 7 --seconds 20 --turns 2 \\
        --out chiprun_out/cost.json

Runs on one H100; exits 2 without a CUDA card.
Prints each window's rate and spans, then the medians and the cost
``1 - on / off`` of the cell's end-to-end rate.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.prepare_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import resolve_device, tracing
    device = resolve_device("cuda:0")
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload)
    cell.seed, cell.device = args.seed, device
    drv = harness.driver(cell).Driver(cell)
    drv.setup()
    gc.collect()
    gc.freeze()
    (rate_name,) = [m["name"] for m in cell.end_to_end
                    if m["name"] != "setup_s"]
    rows = []
    for mode in ("off", "on", "on", "off") * args.turns:
        if mode == "on":
            tracing.start(device)
        win = drv.window(args.seconds)
        spans = len(tracing.stop().spans) if mode == "on" else 0
        rows.append({"tracing": mode, "rate": drv.rate(win)[rate_name],
                     "units": win["units"], "seconds": win["seconds"],
                     "spans": spans})
        print(json.dumps(rows[-1]), flush=True)
    med = {m: statistics.median(r["rate"] for r in rows
                                if r["tracing"] == m) for m in ("off", "on")}
    out = {"card": harness.card_line(), "torch": torch.__version__,
           "workload": cell.name, "seed": args.seed,
           "seconds": args.seconds, "metric": rate_name, "windows": rows,
           "median_off": med["off"], "median_on": med["on"],
           "cost": 1.0 - med["on"] / med["off"]}
    print(json.dumps({k: v for k, v in out.items() if k != "windows"}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
