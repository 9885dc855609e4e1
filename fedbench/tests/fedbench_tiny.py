"""A copy of the benchmark at tiny sizes for CPU tests: the same files and
``BENCHMARK.json``, each configuration and traffic mix cut down."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_LM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
           "d_ff": 128, "vocab_size": 256}
TINY_PODS = {"seq_len": 32, "rows_per_pod": 4, "span_seconds": 0.3,
             "trace_seconds": 0.1}
TINY_FL = {"workers": 3, "images_per_worker": 48, "n_test": 256,
           "span_seconds": 0.3, "trace_seconds": 0.2}
# limits at these sizes on the CPU, between the sound readings (pods: loss
# 3e-5, first gradient 8e-4, merges 4e-3, change 1e-3; fl: 1e-6, 6e-4,
# a flip or two of accuracy) and the planted faults' (0.003 to 1)
TINY_LIMITS = {"pods": {"loss_gap": 1e-3, "grad1_gap": 1e-2,
                        "merge_gap": 2e-2, "change3_gap": 1e-2},
               "fl": {"update1_gap": 1e-3, "change3_gap": 1e-2,
                      "update1_diff": 1e-3, "change3_diff": 1e-2,
                      "acc_gap": 0.05, "missing_updates": 0}}


def _update(path: Path, **kw) -> None:
    d = json.loads(path.read_text())
    d.update(kw)
    path.write_text(json.dumps(d))


def tiny_copy(dst: Path) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``fedbench/`` at tiny sizes;
    returns ``dst``."""
    shutil.copytree(ROOT / "fedbench", dst / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    fb = dst / "fedbench"
    for w in bench["workloads"]:
        kind = json.loads((fb / "configs" / f"{w['config']}.json")
                          .read_text())["kind"]
        if kind == "pods":
            _update(fb / "configs" / f"{w['config']}.json", **TINY_LM)
            _update(fb / "traffic" / f"{w['traffic']}.json", **TINY_PODS)
        else:
            _update(fb / "traffic" / f"{w['traffic']}.json", **TINY_FL)
        (fb / "limits" / f"{w['name']}.json").write_text(
            json.dumps(TINY_LIMITS[kind]))
    return dst


def run(dst: Path, workload: str, trace: int = 0, seed: int = 3_000_000_019,
        **kw):
    """``run.main`` on the CPU in the copy at ``dst``; returns (exit code,
    the result line's object or None)."""
    import contextlib
    import io

    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    sys.path.insert(0, str(dst))
    try:
        from fedbench import run as run_mod
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run_mod.main(["--workload", workload, "--seed", str(seed),
                               "--seconds", "0.3", "--trace", str(trace)],
                              root=dst, here=dst / "fedbench", device="cpu",
                              **kw)
    finally:
        sys.path.remove(str(dst))
        torch.set_num_threads(threads)
    lines = out.getvalue().strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return rc, res
