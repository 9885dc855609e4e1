"""Where a round of the port's runs spends its time on the card.

    PYTHONPATH=src python tools/torch_profile_round.py [--rounds 2]
        [--runs raw/sync,uplink_only/sync] [--prefill [ARCH]]

For each named run of ``chip_smoke.py`` (default: the main path's raw
sync and top-k+int8 uplink sync; e.g. ``hetero/sync/fedadam`` or
``cnn/sync/fedadam`` for the other phases) builds its setup on the CUDA
card, runs one warm-up round, then profiles ``--rounds`` rounds with
``torch.profiler`` (CPU and CUDA activities) and prints, per run: wall
seconds per round (inflated by the profiler itself), the device's busy
time (the sum of kernel times: one stream, so kernels do not overlap)
and idle share, the time inside this repo's kernels, kernel launches per
round, the operators that take the most host time and the kernels that
take the most device time.  With ``--prefill [ARCH]`` it profiles instead
one full-width prefill of 2 prompts of 8192 tokens after a warm-up one:
gemma2-2b (the default, ``chip_smoke.py``'s LM phase, kernel B8 for
attention) or rwkv6-3b (its rwkv6 phase, kernel B9 for the WKV
recurrence), whose device time it splits into the kernel's, cuBLAS's
GEMMs and the rest.  It needs the card and raises without one.
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
               "adam_vec4", "adam_scalar", "flash_fwd", "flash_wgmma",
               "wkv_state_inc", "wkv_scan", "wkv_out")
B8_NAMES = ("flash_fwd", "flash_wgmma")   # B8's SIMT and tensor-core bodies
B9_NAMES = ("wkv_state_inc", "wkv_scan", "wkv_out")   # B9's three passes
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


def _is_gemm(name: str) -> bool:
    return any(n in name.lower() for n in GEMM_NAMES)


def profile_prefill(arch: str):
    """One full-width prefill of ``arch`` (gemma2-2b or rwkv6-3b): the
    device time of its kernel (B8 or B9) against cuBLAS's GEMMs and
    everything else, and the idle share."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    cfg = configs.get_config(arch)
    rwkv = cfg.block_type == "rwkv6"
    if rwkv:
        batch_n, prompt = chip_smoke.RWKV_BATCH, chip_smoke.RWKV_PROMPT
        max_len = prompt + chip_smoke.RWKV_DECODE
    else:
        cfg = cfg.replace(attn_impl="pallas")
        batch_n, prompt = chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT
        max_len = prompt + chip_smoke.LM_DECODE
    params = models.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                                device="cuda")
    batch = next(lm.synthetic_token_batches(
        vocab=cfg.vocab_size, batch=batch_n, seq_len=prompt, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to("cuda")

    def prefill():
        return models.prefill_step(params, {"tokens": tokens}, cfg=cfg,
                                   max_len=max_len)
    prefill()                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    prof, wall = _profile(prefill)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    gemm = sum(_device_us(e) for e in kernels if _is_gemm(e.key)) / 1e3
    print(f"\nprefill {arch} B={batch_n} S={prompt}: wall {wall * 1e3:.3f} "
          f"ms (profiled), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall / 1e3:.3f}; unprofiled wall {bare * 1e3:.3f} "
          f"ms, idle share against it {1 - busy / bare / 1e3:.3f}")
    names, kernel = (B9_NAMES, "B9") if rwkv else (B8_NAMES, "B8")
    own = sum(_device_us(e) for e in kernels
              if any(n in e.key for n in names)) / 1e3
    n_own = sum(e.count for e in kernels if any(n in e.key for n in names))
    n_all = sum(e.count for e in kernels)
    print(f"  {kernel} {own:.3f} ms ({own / busy:.4f} of busy; {n_own} "
          f"kernels), cuBLAS GEMMs {gemm:.3f} ms ({gemm / busy:.4f}), "
          f"other {busy - own - gemm:.3f} ms "
          f"({(busy - own - gemm) / busy:.4f}); {n_all} kernels in all")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"  device {_device_us(e) / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:70]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", default="raw/sync,uplink_only/sync")
    ap.add_argument("--prefill", nargs="?", const=chip_smoke.LM_ARCH,
                    metavar="ARCH", choices=(chip_smoke.LM_ARCH,
                                             chip_smoke.RWKV_ARCH),
                    help="profile one LM prefill of ARCH (default "
                         f"{chip_smoke.LM_ARCH}) instead of FL rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_round: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    print(f"card: {card.stdout.strip()}; torch {torch.__version__}")
    if args.prefill:
        profile_prefill(args.prefill)
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
