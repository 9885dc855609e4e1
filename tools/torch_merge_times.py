"""Time one checkout's B1 (``fedavg_mix_flat``) by W on the card.

    PYTHONPATH=src python tools/torch_merge_times.py --out FILE [--tree DIR]

Runs ``chip_smoke.time_b1`` (with its ``Timer``: median of CUDA events
over 50 launches, L2 flushed before each, in turns with ``torch.addmv``)
at the MLP's padded width N = 101,888: W = 1 (FedAsync merges, s = 0.1),
W = 2 (async_delta's ``delta_vec``: s = 1, weights [1, -1]) and W = 30.
``chip_smoke`` is this checkout's; ``repro_torch`` is DIR's (default:
this checkout), built from DIR's sources, so an older checkout unpacked
with ``git archive`` is timed on the same inputs: run parent, change,
change, parent in one call to compare them on one card.  ``chip_smoke.py``
itself times this checkout's B2 and every fused merge form against the
chain it replaces.  Writes FILE with the card's name and power limit.
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
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))   # ahead of chip_smoke's own
    if not torch.cuda.is_available():
        raise SystemExit("torch_merge_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    by_w = chip_smoke.time_b1(chip_smoke.Timer(dev), g)
    import repro_torch
    rec = {"card": card.stdout.strip(), "tree": str(tree),
           "repro_torch": repro_torch.__file__, "by_w": by_w}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
