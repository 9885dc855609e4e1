"""Where a round of the port's runs spends its time on the card.

    PYTHONPATH=src python tools/torch_profile_round.py [--rounds 2]
        [--runs raw/sync,uplink_only/sync] [--prefill]

For each named run of ``chip_smoke.py`` (default: the main path's raw
sync and top-k+int8 uplink sync; e.g. ``hetero/sync/fedadam`` or
``cnn/sync/fedadam`` for the other phases) builds its setup on the CUDA
card, runs one warm-up round, then profiles ``--rounds`` rounds with
``torch.profiler`` (CPU and CUDA activities) and prints, per run: wall
seconds per round (inflated by the profiler itself), the device's busy
time (the sum of kernel times: one stream, so kernels do not overlap)
and idle share, the time inside this repo's kernels, kernel launches per
round, the operators that take the most host time and the kernels that
take the most device time.  With ``--prefill`` it profiles instead one
prefill of ``chip_smoke.py``'s LM phase (gemma2-2b at full width, 2
prompts of 8192 tokens, kernel B8 for attention) after a warm-up one, and
splits the device time into B8, cuBLAS's GEMMs and the rest.  It needs the
card and raises without one.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402

OWN_KERNELS = ("agg_vec4", "agg_scalar", "mix_vec4", "mix_scalar",
               "encode_kernel", "decode_kernel", "mom_vec4", "mom_scalar",
               "adam_vec4", "adam_scalar", "flash_fwd")
# cuBLAS's GEMM kernels, by the names they carry on Hopper
GEMM_NAMES = ("gemm", "cutlass", "nvjet", "xmma", "sm90_")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _profile(fn):
    """(profiler, wall seconds) of one call of ``fn`` that ends in a
    synchronise."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def profile_prefill():
    """One full-width gemma2-2b prefill: B8's share of device time against
    cuBLAS's GEMMs and everything else."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    cfg = configs.get_config(chip_smoke.LM_ARCH).replace(attn_impl="pallas")
    params = models.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                                device="cuda")
    batch = next(lm.synthetic_token_batches(
        vocab=cfg.vocab_size, batch=chip_smoke.LM_BATCH,
        seq_len=chip_smoke.LM_PROMPT, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to("cuda")
    max_len = chip_smoke.LM_PROMPT + chip_smoke.LM_DECODE

    def prefill():
        return models.prefill_step(params, {"tokens": tokens}, cfg=cfg,
                                   max_len=max_len)
    prefill()                                              # warm-up
    prof, wall = _profile(prefill)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    flash = sum(_device_us(e) for e in kernels if "flash_fwd" in e.key) / 1e3
    gemm = sum(_device_us(e) for e in kernels
               if any(n in e.key.lower() for n in GEMM_NAMES)) / 1e3
    print(f"\nprefill {chip_smoke.LM_ARCH} B={chip_smoke.LM_BATCH} "
          f"S={chip_smoke.LM_PROMPT}: wall {wall * 1e3:.3f} ms (profiled), "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall / 1e3:.3f}"
          f"\n  B8 flash_fwd {flash:.3f} ms ({flash / busy:.4f} of busy), "
          f"cuBLAS GEMMs {gemm:.3f} ms ({gemm / busy:.4f}), other "
          f"{busy - flash - gemm:.3f} ms ({(busy - flash - gemm) / busy:.4f})")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"  device {_device_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:70]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", default="raw/sync,uplink_only/sync")
    ap.add_argument("--prefill", action="store_true",
                    help="profile one LM prefill instead of FL rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_round: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    print(f"card: {card.stdout.strip()}; torch {torch.__version__}")
    if args.prefill:
        profile_prefill()
        return
    for key in args.runs.split(","):
        spec = chip_smoke.RUNS[key]
        table, kw = chip_smoke.PHASES[spec["phase"]]
        setup = core.make_setup(getattr(core, table)["mnist_even"],
                                cfg=MNIST_CNN, model=spec["model"], seed=0,
                                **kw, **spec["setup_kw"], device="cuda")
        rkw = dict(epochs_per_round=chip_smoke.EPOCHS, **spec["run_kw"])
        core.run_fl(setup, max_rounds=1, **rkw)              # warm-up
        prof, wall = _profile(
            lambda: core.run_fl(setup, max_rounds=args.rounds, **rkw))
        events = prof.key_averages()
        # kernel-level events only: operator rows repeat their kernels' time
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_us(e) for e in kernels) / 1e6
        own = sum(_device_us(e) for e in kernels
                  if any(k in e.key for k in OWN_KERNELS)) / 1e6
        launches = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
        print(f"\n{key}: {wall / args.rounds:.4f} s per round "
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
