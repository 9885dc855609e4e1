"""The port's benchmark driver (the twin of ``benchmarks/run.py``): the
bench twins, one function per paper table or figure (``name,us_per_call,
derived`` CSV rows, derived = the figure's headline metric), then the
roofline and FL-collective tables from the port's dry-run records.

    PYTHONPATH=src python benchmarks/torch_run.py              # on the H100
    PYTHONPATH=src python benchmarks/torch_run.py --device cpu
    PYTHONPATH=src python benchmarks/torch_run.py --smoke-topology [--device cpu]

It runs on the card and exits when there is none, unless the CPU is asked
for.  ``--smoke-{topology,chaos,scale,autotune,resume,hetero}`` run
exactly one sweep's smoke form and exit, as ``run.py``'s do
(``--smoke-dlink`` lives in ``torch_fl_figures.py``, as the reference's
lives in ``fl_figures.py``).  The bench twins write under
``benchmarks/results/torch/``; the full sweep tolerates any one bench
dying, and the rest still report.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
# the twins import one another as siblings
sys.path.insert(0, str(HERE))

SMOKE = ("topology", "chaos", "scale", "autotune", "resume", "hetero")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for flag in SMOKE:
        ap.add_argument(f"--smoke-{flag}", action="store_true",
                        help=f"run only the {flag} sweep, smoke form")
    args = ap.parse_args(argv)
    smoke = [f for f in SMOKE if getattr(args, f"smoke_{f}")]
    if len(smoke) > 1:
        ap.error("one --smoke-* flag at a time")
    args.smoke = smoke[0] if smoke else None
    return args


def smoke(flag: str, device) -> None:
    """One sweep's smoke form, as ``run.py``'s ``--smoke-*`` flags run it."""
    import torch_fl_figures
    import torch_scale_bench
    if flag == "scale":
        torch_scale_bench.main(smoke=True, device=device)
        return
    fn = torch_fl_figures.ALL[torch_fl_figures.SMOKE_FLAGS[flag]]
    print(json.dumps(fn(smoke=True, weights0=torch_fl_figures.load_weights0(),
                        device=device), indent=2, default=str))


def main(argv=None) -> None:
    from repro_torch import device_or_exit
    args = parse_args(argv)
    device = device_or_exit(args.device)
    if args.smoke is not None:
        smoke(args.smoke, device)
        return

    import torch_agg_bench
    import torch_agg_shard_bench
    import torch_fl_figures
    import torch_roofline
    import torch_scale_bench
    import torch_wire_bench
    dev = device.type
    benches = {
        "torch_agg_bench": lambda: torch_agg_bench.main(["--device", dev]),
        "torch_agg_shard_bench": lambda: print(json.dumps(
            torch_agg_shard_bench.run(device, smoke=False)["cells"],
            default=str)),
        "torch_wire_bench": lambda: torch_wire_bench.main(["--device", dev]),
        "torch_scale_bench": lambda: torch_scale_bench.main(device=device),
    }
    for name, bench in benches.items():
        try:
            bench()
        except Exception as e:                      # noqa: BLE001
            print(f"[skipped] {name}: {type(e).__name__}: {e}")
        print()

    weights0 = torch_fl_figures.load_weights0()
    print("name,us_per_call,derived")
    for name, fn in torch_fl_figures.ALL.items():
        t0 = time.time()
        try:
            derived = fn(weights0=weights0, device=device)
        except Exception as e:                      # noqa: BLE001
            print(f"{name},0,\"[skipped] {type(e).__name__}\"")
            continue
        us = (time.time() - t0) * 1e6
        short = json.dumps(derived, default=lambda o: round(o, 3)
                           if isinstance(o, float) else str(o))
        short = short.replace(",", ";")
        print(f"{name},{us:.0f},{short}")

    print()
    torch_roofline.main()


if __name__ == '__main__':
    main()
