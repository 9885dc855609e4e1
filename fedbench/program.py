"""The program window: a cell's driver runs with the port's own tracing on
(``repro_torch.tracing``) while the profiler records the device's activity
alone, and what that window reads.

    python3 fedbench/program.py --workload <cell> --seed <n> [--seconds <s>]

sets the cell up as ``run.py`` does, runs its plain window for
``--seconds`` (warm), then one program window of the traffic's
``trace_seconds`` (the pods run on to their next merge, as the trace
window does).  Standard error gets the clock's checks, each span name's
count, host total and median device extent, the counters summed by span,
the cyclic collector's passes and the five longest idle stretches named by
the innermost span open on the host at their middle.  The last line of
standard output is one JSON object with the window's ``readings`` (the
cell kind's entries of ``READINGS`` that found something to read), its
idle share and the clock's checks.  Without a CUDA card it exits 2; where
the program has no tracing, 3.

``run.py`` does not run this window: a ``--trace 1`` run that reported
these readings would call ``program`` after its four windows and pass the
result to the readers, which is an edit to ``run.py``.

Everything below the profiler is plain Python on the recording's spans,
copied into ``SpanRow``s, and the device's operations, as (start, end)
seconds on the profiler's clock.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench import harness, yardstick  # noqa: E402
from fedbench.yardstick import Interval  # noqa: E402


# ---------------------------------------------------------------------------
# Span arithmetic
# ---------------------------------------------------------------------------

class SpanRow(NamedTuple):
    """One span of the program as plain values: its parent is an index
    into the same list; ``host`` and ``device`` are (start, end) seconds on
    the profiler's clock (``device`` None without device events);
    ``device_ms`` the device extent's length; ``counters`` the deltas it
    carries."""
    name: str
    kind: Optional[str]
    parent: Optional[int]
    ids: dict
    host: Interval
    device: Optional[Interval]
    device_ms: Optional[float]
    counters: dict


def overlap_seconds(a: Iterable[Interval], b: Iterable[Interval]) -> float:
    """Seconds in which both a merged interval of ``a`` and one of ``b``
    are open."""
    ua, ub = yardstick.union(a), yardstick.union(b)
    total, i, j = 0.0, 0, 0
    while i < len(ua) and j < len(ub):
        s, e = max(ua[i][0], ub[j][0]), min(ua[i][1], ub[j][1])
        if e > s:
            total += e - s
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(busy: Iterable[Interval], lo: float, hi: float,
               cover: Iterable[Interval]) -> Tuple[float, float]:
    """The idle seconds of [lo, hi] (its complement of the busy union)
    split into (those inside the union of ``cover``, the rest): the two sum
    to the window's idle seconds."""
    idle = yardstick.gaps(busy, lo, hi)
    inside = overlap_seconds(idle, cover)
    return inside, sum(e - s for s, e in idle) - inside


def named(spans: Sequence[SpanRow], name: str) -> List[SpanRow]:
    return [s for s in spans if s.name == name]


def within(spans: Sequence[SpanRow], inner: str, outer: str
           ) -> List[SpanRow]:
    """The ``inner`` spans that have an ``outer`` span among their
    ancestors."""
    out = []
    for s in named(spans, inner):
        p = s.parent
        while p is not None and spans[p].name != outer:
            p = spans[p].parent
        if p is not None:
            out.append(s)
    return out


def host_seconds(spans: Iterable[SpanRow]) -> float:
    return sum(s.host[1] - s.host[0] for s in spans)


def median_device_ms(spans: Sequence[SpanRow]) -> Optional[float]:
    """The median device extent of ``spans`` in ms (None without one)."""
    v = [s.device_ms for s in spans if s.device_ms is not None]
    return statistics.median(v) if v else None


def early_starts(starts: Sequence[float], spans: Iterable[SpanRow]
                 ) -> Tuple[int, float]:
    """The clock's check: device operations (``starts`` sorted) that lie
    in a span's device extent but start before the span's host start, as
    (count, the largest lead in seconds).  Work in a device extent was
    launched inside the span, so on sound clocks the count is 0."""
    n, worst = 0, 0.0
    for s in spans:
        if s.device is None:
            continue
        i = bisect.bisect_left(starts, s.device[0])
        j = bisect.bisect_left(starts, min(s.device[1], s.host[0]))
        if j > i:
            n += j - i
            worst = max(worst, s.host[0] - starts[i])
    return n, worst


def label(s: SpanRow) -> str:
    return s.name if s.kind is None else f"{s.name}[{s.kind}]"


def named_gaps(busy: Iterable[Interval], lo: float, hi: float,
               spans: Sequence[SpanRow], n: int = 5
               ) -> List[Tuple[str, float, float]]:
    """The ``n`` longest idle stretches of [lo, hi] as (the innermost span
    open on the host at the stretch's middle, its start, its seconds)."""
    ops = sorted((s.host[0], s.host[1], label(s)) for s in spans)
    longest = sorted(yardstick.gaps(busy, lo, hi),
                     key=lambda g: g[0] - g[1])[:n]
    return [(yardstick.innermost(ops, (a + b) / 2)
             .replace("host (no op)", "no span"), a, b - a)
            for a, b in longest]


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

@dataclass
class Program:
    """The program window: ``lo`` and ``hi`` are the recording's bounds and
    ``spans`` its spans, all in seconds on the profiler's clock; ``busy``
    the device's operations there; ``units`` the window's units of work;
    ``drift_ms`` how far the host clocks' offset moved between the
    recording's start and stop; ``anchor_us`` the host brackets of the
    device's two reference events."""
    lo: float
    hi: float
    spans: List[SpanRow]
    busy: list
    units: int
    drift_ms: float
    anchor_us: list
    # the cyclic collector's passes in the window: (start, end, generation)
    gc_pauses: list = field(default_factory=list)


def device_intervals(fn: Callable[[], None],
                     sync: Callable[[], None]) -> List[Interval]:
    """Run ``fn`` under ``torch.profiler`` between two synchronisations,
    recording the device's activity alone (as ``harness.profiled`` does),
    and return the device's operations (kernels, copies, sets) as (start,
    end) seconds on the profiler's clock, in no order; none without a
    card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    sync()
    with profile(activities=acts) as prof:
        fn()
        sync()
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            s, d = int(e.start_ns()), int(e.duration_ns())
            out.append((s * 1e-9, (s + d) * 1e-9))
    return out


def program(fn: Callable[[], dict], sync: Callable[[], None],
            device) -> Optional[Program]:
    """Run ``fn`` (a driver's window, returning its ``units``) under the
    profiler with the program's tracing on; None where the program has no
    tracing."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    box, passes = {}, []

    def collector(phase, info):
        passes.append((time.perf_counter_ns(), phase, info["generation"]))

    def run():
        tracing.start(device)
        gc.callbacks.append(collector)
        try:
            box["out"] = fn()
        finally:
            gc.callbacks.remove(collector)
            box["rec"] = tracing.stop()
    busy = device_intervals(run, sync)
    rec = box["rec"]
    pauses = [(rec.to_clock_ns(a) * 1e-9, rec.to_clock_ns(b) * 1e-9, g)
              for (a, pa, g), (b, pb, _) in zip(passes[::2], passes[1::2])
              if (pa, pb) == ("start", "stop")]
    lo, hi = rec.window_s()
    rows = [SpanRow(s.name, s.kind, s.parent, dict(s.ids), rec.host_s(s),
                    rec.device_s(s), rec.device_ms(s), dict(s.counters))
            for s in rec.spans]
    return Program(lo=lo, hi=hi, spans=rows, busy=busy,
                   units=box["out"]["units"],
                   drift_ms=rec.offset_drift_ns * 1e-6,
                   anchor_us=[w * 1e-3 for w in rec.anchor_width_ns],
                   gc_pauses=pauses)


def idle_share(p: Program) -> float:
    """The window's device-idle share, %."""
    return 100.0 * idle_split(p.busy, p.lo, p.hi, [])[1] / (p.hi - p.lo)


def span_counts(p: Program) -> Dict[str, int]:
    """Each span name's count (an event's by its callback)."""
    out: Dict[str, int] = {}
    for s in p.spans:
        k = label(s) if s.name == "fl.event" else s.name
        out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def program_lines(p: Program) -> List[str]:
    """What the log says of the program window: the clock's checks, each
    span name's count, host total and median device extent (an event's
    by its callback), the counters summed by span, the cyclic collector's
    passes, and the five longest idle stretches, named by the innermost
    span open on the host at their middle, with the collector's share."""
    starts = sorted(s for s, _ in p.busy)
    n, lead = early_starts(starts, p.spans)
    idle = idle_split(p.busy, p.lo, p.hi, [])[1]
    out = [f"program window {p.hi - p.lo:.6f} s, {len(p.spans)} spans, "
           f"{len(p.busy)} device ops, idle {idle:.6f} s; clock offset "
           f"drift {p.drift_ms:.6f} ms, device anchors {p.anchor_us} us; "
           f"device ops before their span's host start: {n} "
           f"(largest lead {lead * 1e6:.3f} us)"]
    per = {}
    for s in p.spans:
        per.setdefault(label(s) if s.name == "fl.event" else s.name,
                       []).append(s)
    for name, group in sorted(per.items()):
        dev = median_device_ms(group)
        out.append(f"program window span {name}: {len(group)}, host "
                   f"{1e3 * host_seconds(group):.6f} ms in all"
                   + ("" if dev is None else f", device median {dev:.6f} ms"))
    sums = {}
    for s in p.spans:
        for k, v in s.counters.items():
            sums.setdefault(s.name, {}).setdefault(k, 0)
            sums[s.name][k] += v
    gen2 = [b - a for a, b, g in p.gc_pauses if g == 2]
    out.append(f"program window counters over spans {sums}; the collector "
               f"{len(p.gc_pauses)} passes, "
               f"{sum(b - a for a, b, _ in p.gc_pauses):.6f} s (generation "
               f"2: {len(gen2)}, {sum(gen2):.6f} s)")
    if p.busy:
        for name, a, sec in named_gaps(p.busy, p.lo, p.hi, p.spans):
            gcs = overlap_seconds([(a, a + sec)],
                                  [(s, e) for s, e, _ in p.gc_pauses])
            out.append(f"program window idle {sec:.6f} s at "
                       f"+{a - p.lo:.6f} s: {name} (the collector "
                       f"{gcs:.6f} s of it)")
    return out


# ---------------------------------------------------------------------------
# What the window reads, by the cell's kind.  Each reading takes the window
# (or None) and returns None where it finds nothing to read.
# ---------------------------------------------------------------------------

def train_idle_share(p: Optional[Program]) -> Optional[float]:
    """The share of the window, %, in which the device ran nothing while a
    worker trained (an ``fl.train`` span open on the host).  With
    ``server_idle_share`` it sums to the window's idle share."""
    if p is None or not p.busy:
        return None
    train = [s.host for s in named(p.spans, "fl.train")]
    if not train:
        return None
    return 100.0 * idle_split(p.busy, p.lo, p.hi, train)[0] / (p.hi - p.lo)


def server_idle_share(p: Optional[Program]) -> Optional[float]:
    """The share of the window, %, in which the device ran nothing while
    no worker trained (the event loop, the codecs, the merge, the
    evaluation, the dispatch)."""
    if p is None or not p.busy:
        return None
    train = [s.host for s in named(p.spans, "fl.train")]
    if not train:
        return None
    return 100.0 * idle_split(p.busy, p.lo, p.hi, train)[1] / (p.hi - p.lo)


def server_host_ms_per_update(p: Optional[Program]) -> Optional[float]:
    """The host's time inside the event loop's events (``fl.event``) less
    the time inside the workers' training within them (their ``fl.train``
    descendants), over the updates completed, in ms."""
    if p is None or not p.units:
        return None
    events = named(p.spans, "fl.event")
    if not events:
        return None
    train = within(p.spans, "fl.train", "fl.event")
    return 1e3 * (host_seconds(events) - host_seconds(train)) / p.units


def fwd_bwd_ms(p: Optional[Program]) -> Optional[float]:
    """The median device extent, in ms, of a pod's forward and backward
    (``step.fwd_bwd``: the loss and its gradients, every microbatch)."""
    return None if p is None else median_device_ms(named(p.spans,
                                                         "step.fwd_bwd"))


def optimizer_ms(p: Optional[Program]) -> Optional[float]:
    """The median device extent, in ms, of a pod's AdamW update
    (``step.optimizer``: the clip's norm, the moments, the f32 masters and
    the bf16 copies)."""
    return None if p is None else median_device_ms(named(p.spans,
                                                         "step.optimizer"))


def merge_pack_ms(p: Optional[Program]) -> Optional[float]:
    """The median, over the merges (``pods.merge``), of the device extents
    of the merge's pack (``merge.pack``: the pods into one f32 buffer, and
    in the compressed form the anchor's flatten and the subtraction) plus
    its unpack (``merge.unpack``), in ms."""
    if p is None:
        return None
    per = []
    for i, s in enumerate(p.spans):
        if s.name != "pods.merge":
            continue
        parts = [c.device_ms for c in p.spans if c.parent == i
                 and c.name in ("merge.pack", "merge.unpack")]
        if len(parts) == 2 and None not in parts:
            per.append(sum(parts))
    return statistics.median(per) if per else None


def merge_codec_ms(p: Optional[Program]) -> Optional[float]:
    """The median device extent, in ms, of a compressed merge's encode
    (``merge.encode``: the error-feedback top-k + int8 codec over the
    pods' deltas)."""
    return None if p is None else median_device_ms(named(p.spans,
                                                         "merge.encode"))


def device_frees_per_step(p: Optional[Program]) -> Optional[float]:
    """The caching allocator's device frees (``cudaFree``, each a
    synchronisation of the device) over the local steps, per step: the
    ``alloc.device_frees`` deltas that the ``pods.step`` spans carry."""
    if p is None:
        return None
    steps = [s for s in p.spans if s.name == "pods.step"
             and "alloc.device_frees" in s.counters]
    if not steps:
        return None
    return sum(s.counters["alloc.device_frees"] for s in steps) / len(steps)


READINGS: Dict[str, Dict[str, Callable]] = {
    "fl": {"train_idle_share.fl": train_idle_share,
           "server_idle_share.fl": server_idle_share,
           "server_host_ms_per_update.fl": server_host_ms_per_update},
    "pods": {"fwd_bwd_ms.pods": fwd_bwd_ms,
             "optimizer_ms.pods": optimizer_ms,
             "merge_pack_ms.pods": merge_pack_ms,
             "merge_codec_ms.pods": merge_codec_ms,
             "device_frees_per_step.pods": device_frees_per_step},
}


def readings(p: Optional[Program], kind: str) -> Dict[str, float]:
    """The kind's readings of ``p`` that found something to read."""
    out = {}
    for name, fn in READINGS[kind].items():
        v = fn(p)
        if v is not None:
            out[name] = float(v)
    return out


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------

def log(msg: str) -> None:
    print(f"fedbench program: {msg}", file=sys.stderr, flush=True)


def main(argv=None, *, root: Path = harness.ROOT, here: Path = harness.HERE,
         device=None) -> int:
    """The CLI runs on the card only; ``device`` (tests) runs the same
    steps on another device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the warm plain window before the program window")
    args = ap.parse_args(argv)
    cli = device is None
    harness.prepare_env(root, environ=cli)
    cell = harness.find_cell(args.workload, root, here)
    import torch
    if cli:
        if not torch.cuda.is_available():
            log("needs a CUDA card: no result")
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)
    from repro_torch import resolve_device
    device = resolve_device(device)
    cuda = device.type == "cuda"
    cell.seed, cell.device = args.seed, device
    drv = harness.driver(cell, here).Driver(cell)
    drv.setup()
    if cli:
        gc.collect()
        gc.freeze()
    drv.window(args.seconds)
    if cli:
        gc.unfreeze()
    sync = ((lambda: torch.cuda.synchronize(device)) if cuda
            else (lambda: None))
    prog = program(drv.trace_window, sync, device)
    drv.release()
    if prog is None:
        log("the program has no tracing: no program window")
        return 3
    for line in program_lines(prog):
        log(line)
    n, lead = early_starts(sorted(s for s, _ in prog.busy), prog.spans)
    out = {"card": harness.card_line() if cli else device.type,
           "torch": torch.__version__, "workload": cell.name,
           "seed": args.seed, "window_s": prog.hi - prog.lo,
           "units": prog.units, "spans": span_counts(prog),
           "idle_share": idle_share(prog),
           "drift_ms": prog.drift_ms, "early_starts": n,
           "largest_lead_us": lead * 1e6,
           "readings": readings(prog, cell.config["kind"])}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
