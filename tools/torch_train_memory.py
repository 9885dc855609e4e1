"""Device memory of the production training script, phase by phase: runs
``repro_torch.launch.train`` in this process with ``stack_for_pods``,
``fl_local_step``, ``fl_round`` (and inside it ``_pack_pods``, B2's
``fedavg_agg_flat``, ``_unpack_pods``) and ``train_step`` wrapped, and
prints each call's allocated bytes before, at its peak and after.

    PYTHONPATH=src python tools/torch_train_memory.py --out chiprun_out/mem.json \\
        [-- <trainer arguments>]

On the H100 machine (default: ``--full --layers 48 --mode fl`` at
musicgen-medium, batch 8 x 128, 3 steps, a round after the second).
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import card_name  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.kernels import fedavg_agg  # noqa: E402
from repro_torch.launch import train  # noqa: E402

WRAPPED = ((federated, "stack_for_pods"), (federated, "fl_local_step"),
           (federated, "fl_round"), (federated, "_pack_pods"),
           (fedavg_agg, "fedavg_agg_flat"), (federated, "_unpack_pods"),
           (train, "train_step"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("trainer", nargs="*", default=[
        "--full", "--layers", "48", "--mode", "fl", "--steps", "3",
        "--fl-every", "2", "--lr", "3e-4"])
    args = ap.parse_args(argv)
    calls, top = [], [0]

    def wrap(mod, name):
        real = getattr(mod, name)

        def call(*a, **kw):
            torch.cuda.synchronize()
            top[0] = max(top[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            top[0] = max(top[0], peak)
            calls.append({"call": name, "before": before, "peak": peak,
                          "after": torch.cuda.memory_allocated()})
            print(f"{name}: before {before / 1e9:.3f} GB, peak "
                  f"{peak / 1e9:.3f}, after "
                  f"{calls[-1]['after'] / 1e9:.3f}", flush=True)
            return out
        setattr(mod, name, call)
        return real
    reals = [wrap(mod, name) for mod, name in WRAPPED]
    try:
        s = train.main([*args.trainer, "--ckpt-every", "1000000"])
    finally:
        for (mod, name), real in zip(WRAPPED, reals):
            setattr(mod, name, real)
    top[0] = max(top[0], torch.cuda.max_memory_allocated())
    out = {"card": card_name(), "trainer": args.trainer,
           "n_params": s["n_params"], "calls": calls, "peak": top[0]}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"{s['n_params']:,} parameters a pod; peak {top[0] / 1e9:.3f} GB")


if __name__ == "__main__":
    main()
