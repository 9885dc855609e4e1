"""Roofline tables from the port's dry-run records (the twin of
``benchmarks/roofline.py``): per (arch x shape), the three terms on the
H100, the dominant bottleneck, the MODEL_FLOPS / traced-FLOPs useful
ratio, and whether the peak fits a card.

The records are ``python -m repro_torch.launch.dryrun``'s, under
``benchmarks/results/torch/dryrun/`` (never the reference's
``benchmarks/results/dryrun/``).  Each term is a device's share of the
global trace; the collective term is a model of the cell's shardings
(``launch/hlo_analysis.py``).  ``fits_16gib`` (v5e's HBM) becomes
``fits_80gb``: an H100 80GB HBM3's 80 GB.

    PYTHONPATH=src python benchmarks/torch_roofline.py
"""
from __future__ import annotations

import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parent / "results" / "torch" / "dryrun"
N_CHIPS = {"pod_16x16": 256, "multipod_2x16x16": 512}
HBM_BYTES = 80e9               # H100 80GB HBM3, as sold


def load(mesh: str = "pod_16x16", fl: bool = False):
    rows = []
    d = RESULTS / mesh
    if not d.exists():
        return rows
    for p in sorted(d.glob("*.json")):
        is_fl = "__fl" in p.name
        if is_fl != fl:
            continue
        rec = json.loads(p.read_text())
        if rec["status"] != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": rec["status"],
                         "reason": rec.get("reason", rec.get("error", ""))})
            continue
        for step_name, step in rec["steps"].items():
            r = step["roofline"]
            mf = rec.get("model_flops", {}).get("model_flops_total", 0.0)
            per_dev_model = mf / N_CHIPS[mesh]
            hlo = r["hlo_flops_per_device"]
            peak = step["memory"].get("peak_estimate_bytes", 0)
            rows.append({
                "arch": rec["arch"], "shape": rec["shape"], "step": step_name,
                "status": "ok",
                "t_compute_s": r["t_compute_s"],
                "t_memory_s": r["t_memory_s"],
                "t_collective_s": r["t_collective_s"],
                "dominant": r["dominant"],
                "useful_ratio": (per_dev_model / hlo) if hlo else None,
                "peak_gib": peak / 2**30,
                "fits_80gb": peak < HBM_BYTES,
                "roofline_fraction": (
                    r["t_compute_s"] / max(r["t_compute_s"], r["t_memory_s"],
                                           r["t_collective_s"], 1e-12)),
                "counted": step.get("counted", ""),
            })
    return rows


def table(mesh: str = "pod_16x16") -> str:
    rows = load(mesh)
    hdr = (f"{'arch':<22} {'shape':<12} {'step':<14} {'tc(s)':>9} {'tm(s)':>9} "
           f"{'tx(s)':>9} {'dom':<10} {'useful':>7} {'peak':>8} {'fits':>5} "
           f"{'roofl%':>7}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"{r['arch']:<22} {r['shape']:<12} [{r['status']}] "
                       f"{r.get('reason', '')[:60]}")
            continue
        ur = f"{r['useful_ratio']:.2f}" if r["useful_ratio"] else "-"
        out.append(
            f"{r['arch']:<22} {r['shape']:<12} {r['step']:<14} "
            f"{r['t_compute_s']:>9.4f} {r['t_memory_s']:>9.4f} "
            f"{r['t_collective_s']:>9.4f} {r['dominant']:<10} {ur:>7} "
            f"{r['peak_gib']:>7.2f}G {'yes' if r['fits_80gb'] else 'no':>5} "
            f"{100 * r['roofline_fraction']:>6.1f}%")
    return "\n".join(out)


def fl_comparison() -> str:
    """Sync multi-pod vs federated local-SGD: the paper technique's
    collective-term reduction, a round every 10 local steps."""
    sync = {r["arch"]: r for r in load("multipod_2x16x16")
            if r.get("shape") == "train_4k" and r.get("step") == "train_step"}
    fl = load("multipod_2x16x16", fl=True)
    local = {r["arch"]: r for r in fl if r.get("step") == "fl_local_step"}
    rnd = {r["arch"]: r for r in fl if r.get("step") == "fl_round"}
    out = [f"{'arch':<22} {'sync tx(s)':>11} {'fl tx(s)':>10} {'round tx(s)':>12} "
           f"{'tx saving @H=10':>16}"]
    for arch in sorted(local):
        if arch not in sync:
            continue
        s = sync[arch]["t_collective_s"]
        l = local[arch]["t_collective_s"]
        r = rnd.get(arch, {}).get("t_collective_s", 0.0)
        eff = l + r / 10.0
        out.append(f"{arch:<22} {s:>11.3f} {l:>10.3f} {r:>12.4f} "
                   f"{100 * (1 - eff / max(s, 1e-9)):>15.1f}%")
    return "\n".join(out)


def main() -> None:
    print("== Roofline (single pod, per-device seconds per step) ==")
    print(table("pod_16x16"))
    print()
    print("== Multi-pod (512 cards) ==")
    print(table("multipod_2x16x16"))
    print()
    print("== Paper technique at pod scale: sync-DP vs federated local-SGD ==")
    print(fl_comparison())


if __name__ == "__main__":
    main()
