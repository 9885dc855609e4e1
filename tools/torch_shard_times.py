"""Time one checkout's sharded merges and decodes (B7, B4's sharded forms)
on the card, on meshes that repeat it.

    PYTHONPATH=src python tools/torch_shard_times.py --out FILE [--tree DIR]

Times, with ``chip_smoke.Timer`` (median of CUDA events, L2 flushed before
each call), on meshes of D = 1, 2 and 4 repeating the card
(``agg_mesh(devices=...)``): B7's six forms (``chip_smoke.b7_call``: the
mix, the aggregate, the fused merge and step in both forms, the step in
both forms) at each (W, N) of ``chip_smoke.B7_SIZES`` (256 x 16,777,216,
30 x 102,400, 1 x 102,400), and B4's two sharded forms at N = 102,400 and
16,777,216: ``dequant_add`` on ``Sharded`` q and base, and a merge's 30
encoded responses over one dispatch base landed in a sharded row buffer
through ``ParamBundle._set_rows`` (the sharded server's path).  Beside
them, once a size, the unsharded wrapper on the whole vectors and the one
PyTorch call for the same function (``torch.mv``, ``torch.addmv``,
``torch.add``; none for the rest).  ``chip_smoke`` is this checkout's;
``repro_torch`` is DIR's (default: this checkout), built from DIR's
sources, so an older checkout unpacked with ``git archive`` is timed on
the same inputs: run parent, change, change, parent in one call to compare
them on one card.  Writes FILE with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = (1, 2, 4)
DEC_SIZES = (102_400, 16_777_216)
ROWS_W = 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))   # ahead of chip_smoke's own
    if not torch.cuda.is_available():
        raise SystemExit("torch_shard_times: needs a CUDA card")
    import repro_torch
    from repro_torch.core import flatbuf
    from repro_torch.kernels import topk_quant
    from repro_torch.parallel import sharding as psh
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    rec = {"card": card.stdout.strip(), "tree": str(tree),
           "repro_torch": repro_torch.__file__, "ms": {}}
    ms = rec["ms"]
    for i, (W, N) in enumerate(cs.B7_SIZES):
        n = cs.N_TIMED_B7 if W * N > 1 << 28 else 2 * cs.N_TIMED_B7
        o = cs.b7_inputs(dev, W, N, seed=100 + i)
        for form in cs.B7_FORMS:
            ms[f"B7 {form} {W}x{N} unsharded"] = timer(
                lambda: cs.b7_call(form, o), n)
        ms[f"B7 mix {W}x{N} torch.addmv"] = timer(
            lambda: torch.addmv(o["server"], o["rows"].t(), o["w_mix"],
                                beta=cs.B7_S), n)
        ms[f"B7 agg {W}x{N} torch.mv"] = timer(
            lambda: torch.mv(o["rows"].t(), o["w"]), n)
        for D in MESHES:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            o_sh = cs.b7_sharded(o, mesh)
            for form in cs.B7_FORMS:
                ms[f"B7 {form} {W}x{N} D = {D}"] = timer(
                    lambda: cs.b7_call(form, o_sh, mesh), n)
            del o_sh
        del o
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(29)
    for N in DEC_SIZES:
        n = cs.N_TIMED_SHARD
        qs, scales, base = cs.shard_dec_inputs(g, N, ROWS_W)
        rows = torch.empty(ROWS_W, N, device=dev)
        scale_f = float(scales[0])
        ms[f"B4 {N} unsharded"] = timer(
            lambda: topk_quant.dequant_add(qs[0], scales[0], base), n)
        ms[f"B4 {N} torch.add"] = timer(
            lambda: torch.add(base, qs[0], alpha=scale_f), n)
        ms[f"B4 rows {ROWS_W}x{N} unsharded"] = timer(
            lambda: topk_quant.dequant_add_rows(qs, scales,
                                                [base] * ROWS_W, rows), n)
        for D in MESHES:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            q_sh, b_sh = psh.split(qs[0], mesh), psh.split(base, mesh)
            ms[f"B4 {N} D = {D}"] = timer(
                lambda: topk_quant.dequant_add(q_sh, scales[0], b_sh), n)
            bundle = flatbuf.ParamBundle(
                {"w": torch.empty(N, device="meta")}, mesh=mesh)
            vecs = [flatbuf.EncodedVec(psh.split(q, mesh), s, b_sh)
                    for q, s in zip(qs, scales)]
            rows_sh = psh.split(rows, mesh)
            ms[f"B4 rows {ROWS_W}x{N} D = {D}"] = timer(
                lambda: bundle._set_rows(rows_sh, vecs), n)
            del q_sh, b_sh, vecs, rows_sh
        del qs, scales, base, rows
        torch.cuda.empty_cache()
    print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
