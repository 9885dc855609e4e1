"""The production training script (``repro_torch.launch.train``) at several
learning rates on the same batches: every step's loss, to see where the
loss falls.  ``chip_smoke.py`` phase 15 takes its single-mode rate and
step count from this scan.

    PYTHONPATH=src python tools/torch_train_lr_scan.py --out chiprun_out/lr.json \\
        [--lrs 0,3e-4,1e-3] [--steps 30] [-- <trainer arguments>]

On the H100 machine by default (the trainer's ``--full`` musicgen-medium,
batch 8 x 128); ``-- --device cpu`` runs a REDUCED config on the CPU.
A rate of 0 gives each batch's loss with no training.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import card_name  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--lrs", default="0,3e-4,1e-3")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("trainer", nargs="*",
                    default=["--full", "--batch", "8", "--seq", "128"])
    args = ap.parse_args(argv)
    out = {"card": card_name(), "trainer": args.trainer, "losses": {}}
    for lr in args.lrs.split(","):
        s = train.main([*args.trainer, "--steps", str(args.steps), "--lr", lr,
                        "--ckpt-every", str(args.steps + 1)])
        out["losses"][lr] = s["losses"]
        del s
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for lr, losses in out["losses"].items():
        print(f"lr {lr}: {[round(x, 4) for x in losses]}")


if __name__ == "__main__":
    main()
