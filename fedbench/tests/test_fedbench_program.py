"""The program window (``fedbench/program.py``): its readings on hand-built
recordings and device intervals, the span arithmetic under them, and its
command on the tiny CPU copy of every cell, with and without the program's
tracing (as on a parent that has none)."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import fedbench_tiny as tiny  # noqa: E402

from fedbench import program as pw, yardstick as ys  # noqa: E402
from fedbench.program import SpanRow  # noqa: E402

NEW = {"mnist-cnn.w30-sync": ["train_idle_share.fl", "server_idle_share.fl",
                              "server_host_ms_per_update.fl"],
       "musicgen-pods.raw-h10": ["fwd_bwd_ms.pods", "optimizer_ms.pods",
                                 "merge_pack_ms.pods",
                                 "device_frees_per_step.pods"],
       "musicgen-pods.topk-h1": ["fwd_bwd_ms.pods", "optimizer_ms.pods",
                                 "merge_pack_ms.pods", "merge_codec_ms.pods",
                                 "device_frees_per_step.pods"]}
ALL_NEW = sorted({m for v in NEW.values() for m in v})
KIND = {m: kind for kind, r in pw.READINGS.items() for m in r}


def row(name, parent, host, device=None, kind=None, counters=None, **ids):
    ms = None if device is None else 1e3 * (device[1] - device[0])
    return SpanRow(name, kind, parent, ids, host, device, ms,
                   counters or {})


def program(spans, busy, lo=0.0, hi=10.0, units=4):
    return pw.Program(lo=lo, hi=hi, spans=spans, busy=busy, units=units,
                      drift_ms=0.0, anchor_us=[])


def read(metric, prog):
    return pw.READINGS[KIND[metric]][metric](prog)


def fl_program():
    # two events; the first trains a worker inside it, the second merges
    spans = [row("fl.event", None, (1.0, 4.0), kind="W._finish"),
             row("fl.train", 0, (1.5, 3.5), round=0, worker="w0"),
             row("fl.encode_up", 0, (3.5, 3.6), worker="w0"),
             row("fl.event", None, (5.0, 8.0), kind="S._on_response"),
             row("fl.merge", 3, (5.0, 6.0), round=0),
             row("fl.eval", 3, (6.0, 8.0), round=0),
             row("fl.train", None, (8.5, 9.0), round=1, worker="w1")]
    busy = [(0.0, 2.0), (3.0, 6.0), (7.0, 8.75), (9.5, 12.0)]
    return program(spans, busy)


def test_idle_shares_split_the_windows_idle_share():
    p = fl_program()
    # idle: (2, 3), (6, 7), (8.75, 9.5) = 2.75 s of 10; trains open over
    # (1.5, 3.5) and (8.5, 9.0): idle inside them (2, 3) and (8.75, 9.0)
    train = read("train_idle_share.fl", p)
    server = read("server_idle_share.fl", p)
    assert train == pytest.approx(100 * 1.25 / 10)
    assert server == pytest.approx(100 * 1.5 / 10)
    idle = sum(e - s for s, e in ys.gaps(p.busy, p.lo, p.hi))
    assert train + server == pytest.approx(100 * idle / (p.hi - p.lo),
                                           abs=1e-12)
    assert pw.idle_share(p) == pytest.approx(train + server, abs=1e-12)


def test_server_host_time_per_update():
    # events 3 + 3 s, the train inside the first 2 s (the one outside any
    # event is not subtracted): 4 s over 4 updates
    assert read("server_host_ms_per_update.fl", fl_program()) == \
        pytest.approx(1e3)


def pods_program(compressed=True):
    spans, frees = [], [3, 5]
    for step in (1, 2):
        st = len(spans)
        spans.append(row("pods.step", None, (0, 1), step=step,
                         counters={"alloc.device_frees": frees[step - 1],
                                   "alloc.retries": 0}))
        for pod in (0, 1):
            ps = len(spans)
            spans.append(row("pods.pod_step", st, (0, 1), step=step,
                             pod=pod))
            base = 10.0 * step + pod
            spans.append(row("step.fwd_bwd", ps, (0, 1), (base, base + 0.4)))
            spans.append(row("step.optimizer", ps, (0, 1),
                             (base + 0.4, base + 0.5 + 0.01 * step)))
            spans.append(row("step.grad_norm", ps, (0, 1), (0.5, 0.501)))
        m = len(spans)
        spans.append(row("pods.merge", None, (0, 1), step=step))
        parts = ["merge.pack"] + (["merge.encode"] if compressed else []) + \
            ["merge.combine", "merge.unpack"]
        for k, name in enumerate(parts):
            t = 100.0 * step + k
            spans.append(row(name, m, (0, 1),
                             (t, t + 0.001 * (k + 1) * step)))
    return program(spans, [])


def test_pod_readers():
    p = pods_program()
    assert read("fwd_bwd_ms.pods", p) == pytest.approx(400.0)
    assert read("optimizer_ms.pods", p) == pytest.approx(
        (110.0 + 120.0) / 2)
    # pack + unpack: 1 + 4 ms at step 1, 2 + 8 at step 2
    assert read("merge_pack_ms.pods", p) == pytest.approx((5.0 + 10.0) / 2)
    assert read("merge_codec_ms.pods", p) == pytest.approx((2.0 + 4.0) / 2)
    assert read("device_frees_per_step.pods", p) == pytest.approx(4.0)
    raw = pods_program(compressed=False)
    assert read("merge_codec_ms.pods", raw) is None
    # raw: pack 1 ms, combine 2, unpack 3 (x step)
    assert read("merge_pack_ms.pods", raw) == pytest.approx((4.0 + 8.0) / 2)


@pytest.mark.parametrize("metric", ALL_NEW)
def test_readers_return_none_without_spans(metric):
    assert read(metric, None) is None
    assert read(metric, program([], [(0.0, 1.0)])) is None


@pytest.mark.parametrize("metric", ["fwd_bwd_ms.pods", "optimizer_ms.pods",
                                    "merge_pack_ms.pods",
                                    "merge_codec_ms.pods",
                                    "device_frees_per_step.pods",
                                    "train_idle_share.fl",
                                    "server_idle_share.fl"])
def test_device_readers_return_none_off_the_device(metric):
    # spans with no device extents, no counters, no device operations: a
    # CPU run
    spans = [SpanRow(s.name, s.kind, s.parent, s.ids, s.host, None, None,
                     {}) for s in pods_program().spans + fl_program().spans]
    assert read(metric, program(spans, [])) is None


def test_overlap_split_and_within():
    assert pw.overlap_seconds([(0, 2), (1, 3), (5, 6)], [(2.5, 5.5)]) == \
        pytest.approx(1.0)
    assert pw.overlap_seconds([], [(0, 1)]) == 0.0
    inside, outside = pw.idle_split([(1, 2)], 0, 4, [(0.5, 3)])
    assert (inside, outside) == (pytest.approx(1.5), pytest.approx(1.5))
    p = fl_program()
    assert [s.host for s in pw.within(p.spans, "fl.train", "fl.event")] == \
        [(1.5, 3.5)]


def test_clock_check_counts_early_device_operations():
    spans = [row("a", None, (1.0, 2.0), (1.1, 2.5)),
             row("b", None, (3.0, 4.0), (2.9, 4.5)),
             row("c", None, (5.0, 6.0))]
    assert pw.early_starts([1.2, 2.0, 2.95, 3.2], spans) == \
        (1, pytest.approx(0.05))
    assert pw.early_starts([1.2, 3.05], spans) == (0, 0.0)


def test_idle_stretches_are_named_by_the_innermost_span():
    p = fl_program()
    got = pw.named_gaps(p.busy, p.lo, p.hi, p.spans, n=3)
    assert [(name, round(a, 6), round(sec, 6)) for name, a, sec in got] == [
        ("fl.train", 2.0, 1.0), ("fl.eval", 6.0, 1.0),
        ("no span", 8.75, 0.75)]
    p.gc_pauses = [(2.5, 2.75, 2), (6.0, 6.1, 0)]
    lines = pw.program_lines(p)
    assert "device ops before their span's host start: 0" in lines[0]
    # one line a span name (an event's by its callback), sorted
    assert lines[1:7] == [
        "program window span fl.encode_up: 1, host 100.000000 ms in all",
        "program window span fl.eval: 1, host 2000.000000 ms in all",
        "program window span fl.event[S._on_response]: 1, host "
        "3000.000000 ms in all",
        "program window span fl.event[W._finish]: 1, host 3000.000000 ms "
        "in all",
        "program window span fl.merge: 1, host 1000.000000 ms in all",
        "program window span fl.train: 2, host 2500.000000 ms in all"]
    assert "2 passes, 0.350000 s (generation 2: 1, 0.250000 s)" in lines[7]
    assert len(lines) == 8 + 3
    assert lines[8].endswith("fl.train (the collector 0.250000 s of it)")
    assert lines[9].endswith("fl.eval (the collector 0.100000 s of it)")
    assert "device median 400.000000 ms" in [
        x for x in pw.program_lines(pods_program())
        if "step.fwd_bwd" in x][0]
    assert pw.label(p.spans[0]) == "fl.event[W._finish]"


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.tiny_copy(tmp_path_factory.mktemp("program"))


def run_program(dst, cell):
    """``program.main`` on the CPU in the copy at ``dst``: (exit code, the
    last line's object or None)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pw.main(["--workload", cell, "--seed", "3000000019",
                      "--seconds", "0.2"], root=dst, here=dst / "fedbench",
                     device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{")
                else None)


# what every unit of work opens (a window may end before a round's merge in
# FL; the pods' window runs on to its merge)
SPANS = {"fl": {"fl.train", "fl.encode_up"},
         "pods": {"pods.step", "pods.pod_step", "step.fwd_bwd",
                  "step.optimizer", "step.grad_norm", "pods.merge",
                  "merge.pack", "merge.combine", "merge.unpack"}}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_program_window_of_tiny_cells(copy, cell, monkeypatch):
    kind = "fl" if cell.startswith("mnist") else "pods"
    rc, res = run_program(copy, cell)
    assert rc == 0 and res["workload"] == cell and res["units"] > 0
    names = set(res["spans"])
    assert SPANS[kind] <= {n.split("[")[0] for n in names}
    assert ("merge.encode" in names) == cell.endswith("topk-h1")
    if kind == "fl":
        assert any(n.startswith("fl.event[") for n in names)
    # on the CPU the host-side reading reads; the device-side ones find no
    # device extents, counters or device operations
    assert set(res["readings"]) == \
        {"server_host_ms_per_update.fl"} & set(NEW[cell])
    assert res["early_starts"] == 0
    with monkeypatch.context() as m:
        # the program without its tracing, as a parent commit is
        import repro_torch
        m.delattr(repro_torch, "tracing")
        m.setitem(sys.modules, "repro_torch.tracing", None)
        rc0, res0 = run_program(copy, cell)
    assert rc0 == 3 and res0 is None
    # the benchmark's own traced run is as the benchmark has it
    rc1, res1 = tiny.run(copy, cell, trace=1)
    assert rc1 == 0 and res1["correct"] is True
    assert not set(res1["metrics"]) & set(ALL_NEW)
