"""The benchmark of the PyTorch/CUDA port.

    python fedbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its files by name (see
``harness``), makes the cell's inputs on the card from ``--seed``, builds
and warms the program (set-up), runs the window for ``--seconds``, and
then holds what the program computed in its first steps against the plain
reference.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones: after the plain window of ``--seconds``, a span
window of the traffic's ``span_seconds`` (each call synchronised before
and after), a profiled window of its ``trace_seconds`` (the device's
activity alone) and a second one as long that also records the host's
operators, to name the device's idle stretches.  ``setup_s`` counts from
the end of torch's import: the program's import, the kernel library, the
inputs, the program built and its checked first steps.  The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"fedbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None, *, root: Path = harness.ROOT, here: Path = harness.HERE,
         device=None, driver_kw=None) -> int:
    """The CLI runs on the card only; ``device`` (tests) runs the same
    steps on another device."""
    args = parse(argv)
    cli = device is None
    # a test's process may hold JAX already: the check is of this run's
    before = frozenset() if cli else frozenset(harness.top_level_modules())
    harness.prepare_env(root, environ=cli)
    cell = harness.find_cell(args.workload, root, here)
    import torch
    t_setup = time.perf_counter()
    log(f"torch imported at {t_setup - T_START:.3f} s")
    if cli:
        need = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            log(f"needs {need} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                ": no result")
            return 2
        device = torch.device("cuda", 0)
    from repro_torch import resolve_device
    device = resolve_device(device)
    if cli:
        torch.set_num_threads(1)
    cuda = device.type == "cuda"
    print(f"fedbench card: {harness.card_line()}; torch {torch.__version__}"
          f"; workload {cell.name} seed {args.seed}", flush=True)
    cell.seed, cell.device = args.seed, device
    drv = harness.driver(cell, here).Driver(cell, **(driver_kw or {}))
    log(f"driver loaded at {time.perf_counter() - T_START:.3f} s")
    drv.setup()
    setup_s = time.perf_counter() - t_setup
    if cli:
        # set-up's objects out of the cyclic collector's passes in the window
        gc.collect()
        gc.freeze()
    log(f"set-up {setup_s:.3f} s")

    trace = twin = None
    win = drv.window(args.seconds)
    if cli:
        gc.unfreeze()
    if args.trace:
        drv.span_window()
        box = {}
        sync = ((lambda: torch.cuda.synchronize(device)) if cuda
                else (lambda: None))
        trace = harness.profiled(lambda: box.update(drv.trace_window()),
                                 sync)
        twin = box
        trace.idle_gaps = harness.profiled(
            lambda: drv.window(cell.traffic["trace_seconds"]), sync,
            host=True).idle_gaps
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    facts = drv.facts()
    attempted, failed = win["units"], drv.failed()
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules(before)
    if bad:
        log(f"modules of the JAX package or JAX loaded: {bad}: no result")
        return 3
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(c["ok"] for c in checks)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda
           else device.type, "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        ctx = SimpleNamespace(window=win, spans=drv.spans, trace=trace,
                              trace_window=twin, facts=facts,
                              kernel_seconds=lambda m: harness.kernel_seconds(
                                  trace, m))
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"], here).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        breakdown = {"device_ops": trace.device_ops,
                     "idle_gaps": trace.idle_gaps}
    else:
        rates = drv.rate(win)
        metrics = {m["name"]: {"value": float(rates[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in rates}
        names = {m["name"] for m in cell.end_to_end}
        if "setup_s" in names:
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for c in checks:
        log(f"{c['name']} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAIL'}")
    out = harness.result(correct=correct, attempted=attempted, failed=failed,
                         metrics=metrics, device=dev, checks=checks,
                         breakdown=breakdown)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
