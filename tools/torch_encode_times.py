"""Time one checkout's ``ef_encode`` on the card, grid and sharded forms.

    PYTHONPATH=src python tools/torch_encode_times.py --out FILE [--tree DIR]
        [--pods]

Times, with ``chip_smoke.Timer`` (median of CUDA events, L2 flushed before
each call), top-k+int8 encodes of x = (a - b) + c drawn as
``chip_smoke.ef_inputs`` draws "parts": the cluster form at the MLP's
width (101,888), the grid form at 16,777,216 and at the pod width
(1,216,389,120, also with x alone, as the compressed pod round calls it;
``N_TIMED_PODS`` runs), and the sharded form on meshes of 2 and 4
repeating the card at 102,400 and 16,777,216.  With ``--pods`` it also
runs ``chip_smoke.run_pods_fl`` (phase 14's pod FL at yi-9b's width, 2
layers, 2 pods) and records its compressed round's seconds.
``chip_smoke`` is this checkout's; ``repro_torch`` is DIR's (default:
this checkout), built from DIR's sources, so an older checkout unpacked
with ``git archive`` is timed on the same inputs: run parent, change,
change, parent in one call to compare them on one card.  Writes FILE with
the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"cluster": (101_888, 101_770, 10_177),
         "grid": (16_777_216, 16_777_216, 1_677_721),
         "pods": (1_216_389_120, 1_216_389_120, 121_638_912)}
SHARD_SIZES = ((102_400, 101_770, 10_177),
               (16_777_216, 16_777_216, 1_677_721))
MESHES = (2, 4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--pods", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))   # ahead of chip_smoke's own
    if not torch.cuda.is_available():
        raise SystemExit("torch_encode_times: needs a CUDA card")
    import repro_torch
    from repro_torch.kernels import topk_quant
    from repro_torch.parallel import sharding as psh
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    rec = {"card": card.stdout.strip(), "tree": str(tree),
           "repro_torch": repro_torch.__file__, "ms": {}}
    for label, (N, n_params, k) in SIZES.items():
        kw = dict(k=k, n_params=n_params, quantize=True)
        a, b, c = cs.ef_inputs(g, N, "parts")
        n = cs.N_TIMED_PODS if label == "pods" else cs.N_TIMED
        rec["ms"][label] = timer(lambda: topk_quant.ef_encode(a, b, c, **kw),
                                 n)
        if label == "pods":
            x = (a - b) + c
            del a, b, c
            rec["ms"]["pods, x alone"] = timer(
                lambda: topk_quant.ef_encode(x, **kw), n)
            del x
        else:
            del a, b, c
        torch.cuda.empty_cache()
    for N, n_params, k in SHARD_SIZES:
        kw = dict(k=k, n_params=n_params, quantize=True)
        a, b, c = cs.shard_enc_inputs(g, N)
        for D in MESHES:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            sh = [psh.split(t, mesh) for t in (a, b, c)]
            rec["ms"][f"sharded {N} D = {D}"] = timer(
                lambda: topk_quant.ef_encode(*sh, **kw), cs.N_TIMED_SHARD)
            del sh
        del a, b, c
        torch.cuda.empty_cache()
    if args.pods:
        pods = {}
        cs.run_pods_fl(dev, pods)
        rec["pods_fl"] = {k: pods[k] for k in (
            "fl_round_s", "fl_round_delta_compressed_s", "ef_encode_N",
            "ef_encode_kept", "launches_compressed")}
    print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
