"""What every cell's run shares: finding a cell's files by name, the card's
description, the profiled window and its reduction, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files are
found by name: ``configs/<config>.json`` (through the configuration's
``file``), ``traffic/<traffic>.json``, ``limits/<cell>.json``,
``drivers/<kind>.py`` (``kind`` from the configuration file) and, for each
per-layer metric, ``metrics/<metric>.py`` (or, for a metric split by the
end-to-end metric it moves, ``<name>.<kind>``, a shared ``metrics/<name>.py``).
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from fedbench import yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 160          # a kernel's or op's name in the breakdown


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int = 0
    device: object = None


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_bench(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell, here: Path = HERE):
    kind = cell.config["kind"]
    return load_file(here / "drivers" / f"{kind}.py", f"fedbench_driver_{kind}")


def reader(metric: str, here: Path = HERE):
    path = here / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return load_file(path,
                     "fedbench_metric_" + metric.replace(".", "_")
                     .replace("-", "_"))


def prepare_env(root: Path = ROOT, *, environ: bool = True) -> None:
    """The program's own package on the path; with ``environ`` (a process
    of the benchmark's own), build and kernel caches at fixed paths inside
    the checkout, one host thread for CPU-side operators (the card's work
    is dispatched from the main thread, and idle OpenMP workers spin on
    shared cores) and no JAX for libraries that would load it."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if not environ:
        return
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    """The card's name, power limit and SM clocks as nvidia-smi reads
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def top_level_modules() -> set:
    return {m.split(".")[0] for m in list(sys.modules)}


def forbidden_modules(before: frozenset = frozenset()) -> List[str]:
    """JAX's or the JAX package's modules loaded, top-level names compared
    whole, leaving out those in ``before``."""
    return sorted((top_level_modules() & set(FORBIDDEN)) - before)


# ---------------------------------------------------------------------------
# The profiled window
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    n_kernels: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _ns(e, which: str) -> int:
    return int(getattr(e, f"{which}_ns")())


def profiled(fn: Callable[[], None], sync: Callable[[], None], *,
             host: bool = False) -> Trace:
    """Run ``fn`` under ``torch.profiler`` between two synchronisations and
    reduce the trace: the device's busy union of kernels, copies and sets
    over the window's wall length, each kernel's count and seconds.  The
    device activity alone is recorded, since recording every host operator
    slows a host-paced window; with ``host`` the host's operators too, and
    the ten longest idle stretches between device operations are named by
    the innermost host op open at their middle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:        # a test's run without a card: host only
        acts.append(ProfilerActivity.CPU)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    dev, ops_host, kernels = [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, d = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            name = e.name()[:NAME_CHARS]
            dev.append((s * 1e-9, (s + d) * 1e-9, name))
            if not name.startswith(("Memcpy", "Memset")):
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += d * 1e-9
        elif not e.is_user_annotation():
            ops_host.append((s * 1e-9, (s + d) * 1e-9,
                             e.name()[:NAME_CHARS]))
    if not dev:
        return Trace(window_s=window, busy_s=0.0)
    lo = min(s for s, _, _ in dev)
    hi = max(e for _, e, _ in dev)
    iv = [(s, e) for s, e, _ in dev]
    busy = yardstick.busy_seconds(iv, lo, hi)
    idle = []
    if host:
        ops_host.sort()
        longest = sorted(yardstick.gaps(iv, lo, hi),
                         key=lambda g: g[0] - g[1])
        idle = yardstick.top(
            (yardstick.innermost(ops_host, (a + b) / 2), b - a)
            for a, b in longest[:500])
    ops = yardstick.top((n, v[1]) for n, v in kernels.items())
    return Trace(window_s=window, busy_s=busy,
                 kernels={n: list(v) for n, v in kernels.items()},
                 n_kernels=sum(v[0] for v in kernels.values()),
                 device_ops=ops, idle_gaps=idle)


def kernel_seconds(trace: Trace, match: Callable[[str], bool]) -> tuple:
    """(launches, seconds) of the kernels whose name ``match`` accepts."""
    n, s = 0, 0.0
    for name, (c, sec) in trace.kernels.items():
        if match(name):
            n += c
            s += sec
    return n, s


# ---------------------------------------------------------------------------
# The result line
# ---------------------------------------------------------------------------

def result(*, correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: List[dict],
           breakdown: Optional[dict] = None) -> dict:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {c["name"]: {"value": c["value"]
                                   if math.isfinite(c["value"]) else
                                   str(c["value"]), "limit": c["limit"]}
                       for c in checks}
    return out
