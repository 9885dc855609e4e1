"""Time one checkout's B8 (flash attention) at ``chip_smoke.FLASH_SHAPES``.

    PYTHONPATH=src python tools/torch_flash_times.py --out FILE [--tree DIR]
        [--shapes LABEL,...]

For each bf16 shape of ``chip_smoke.FLASH_SHAPES`` (or the labels given),
draws q, k, v as ``chip_smoke.check_flash`` does, holds the kernel against
its plain version (``chip_smoke.flash_ratio``, which passes at <= 1) and
times it with ``chip_smoke.Timer`` (median of CUDA events over
``N_TIMED_FLASH`` launches, L2 flushed before each).  ``chip_smoke`` is
this checkout's; ``repro_torch`` is DIR's (default: this checkout), built
from DIR's sources, so another body unpacked into a git-ignored directory
is timed on the same inputs: run A, B, B, A in one call to compare two on
one card.  Writes FILE with the card's name and power limit; exits
non-zero if a shape misses the limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--shapes", default="",
                    help="comma-separated FLASH_SHAPES labels (default: "
                         "every bf16 one)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))   # ahead of chip_smoke's own
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_times: needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    labels = ([s for s in args.shapes.split(",") if s] or
              [k for k, v in chip_smoke.FLASH_SHAPES.items()
               if v[5] == torch.bfloat16])
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = {}
    for label in labels:
        B, S, H, Kv, D, dt, window, cap = chip_smoke.FLASH_SHAPES[label]
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=g)
                   for n in (H, Kv, Kv))
        q, k, v = (q * chip_smoke.FLASH_Q_SCALE).to(dt), k.to(dt), v.to(dt)
        kw = dict(window=window, softcap=cap)
        ratio = chip_smoke.flash_ratio(
            fa.flash_attention(q, k, v, **kw),
            ref.reference_flash_attention(q, k, v, **kw))
        ms = timer(lambda: fa.flash_attention(q, k, v, **kw),
                   chip_smoke.N_TIMED_FLASH)
        shapes[label] = {"ratio": ratio, "ms": ms}
        print(f"{label}: {ms:.4f} ms, ratio {ratio:.4f} ({tree})",
              flush=True)
        del q, k, v
    import repro_torch
    rec = {"card": card.stdout.strip(), "tree": str(tree),
           "repro_torch": repro_torch.__file__, "shapes": shapes}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    if not all(r["ratio"] <= 1.0 for r in shapes.values()):
        raise SystemExit("torch_flash_times: a shape misses the limit")


if __name__ == "__main__":
    main()
