"""Where a round of the port's main path spends its time on the card.

    PYTHONPATH=src python tools/torch_profile_round.py [--rounds 2]

Builds the main-path setup of ``chip_smoke.py`` (TABLE_4_2 mnist_even,
MNIST width, het strong, 10 local epochs) on the CUDA card, runs one
warm-up round, then profiles ``--rounds`` rounds of raw sync and of
top-k+int8 uplink sync with ``torch.profiler`` (CPU and CUDA activities)
and prints, per run: wall seconds per round (inflated by the profiler
itself), the device's busy time (the sum of kernel times: one stream, so
kernels do not overlap) and idle share, the time inside this repo's four
kernels, kernel launches per round, the operators that take the most
host time and the kernels that take the most device time.  It needs the card and raises
without one.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.core import TABLE_4_2, make_setup, run_fl  # noqa: E402

OWN_KERNELS = ("agg_vec4", "agg_scalar", "mix_vec4", "mix_scalar",
               "encode_kernel", "decode_kernel")
TRANSPORTS = {"raw": dict(transport="raw"),
              "uplink_only": dict(transport="topk_ef+int8",
                                  transport_down="raw", transport_frac=0.1)}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_round: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    print(f"card: {card.stdout.strip()}; torch {torch.__version__}")
    setup = make_setup(TABLE_4_2["mnist_even"], cfg=MNIST_CNN, het="strong",
                       seed=0, device="cuda")
    for tname, tkw in TRANSPORTS.items():
        run_fl(setup, epochs_per_round=10, max_rounds=1, **tkw)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_fl(setup, epochs_per_round=10, max_rounds=args.rounds,
                   **tkw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # kernel-level events only: operator rows repeat their kernels' time
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_us(e) for e in kernels) / 1e6
        own = sum(_device_us(e) for e in kernels
                  if any(k in e.key for k in OWN_KERNELS)) / 1e6
        launches = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
        print(f"\n{tname}/sync: {wall / args.rounds:.4f} s per round "
              f"(profiled); device busy {busy:.4f} s of {wall:.4f} s, idle "
              f"share {1 - busy / wall:.3f}; this repo's kernels "
              f"{own * 1e3:.3f} ms; {launches / args.rounds:.0f} kernel "
              f"launches per round")
        if busy == 0.0:
            print("  the profiler recorded no device time")
        print(events.table(sort_by="self_cpu_time_total", row_limit=12,
                           max_name_column_width=40))
        by_device = sorted(kernels, key=_device_us, reverse=True)[:8]
        for e in by_device:
            print(f"  device {_device_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
                  f"{e.key[:70]}")


if __name__ == "__main__":
    main()
