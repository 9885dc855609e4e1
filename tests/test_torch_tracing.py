"""The port's tracer (``repro_torch.tracing``) on the CPU: off it records
nothing and hands out one shared no-op; on it records nesting, parents,
shared ids, self time and counter deltas, maps its host clock onto the
profiler's within a millisecond, and makes no device events off CUDA; and
the spans inside the FL loop and the pods land where they should without
moving a bit of any history, parameter or loss."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs, models, optim, tracing
from repro_torch.core import TABLE_4_1, federated, make_setup, run_fl
from repro_torch.core.compression import ErrorFeedbackCompressor
from repro_torch.tree import leaves, tree_map


@pytest.fixture(autouse=True)
def _no_recording_left():
    yield
    if tracing._REC is not None:
        tracing.stop()


def _spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_off_hands_out_the_shared_noop_and_records_nothing():
    assert tracing._REC is None
    a, b = tracing.span("a"), tracing.span("b", kind=print, step=tracing.NEXT)
    assert a is b
    with a as got:
        assert got is None
    assert tracing.count("n", 3) is None
    assert tracing.alloc_counters() == {}
    tracing.start("cpu")
    rec = tracing.stop()
    assert rec.spans == [] and rec.counters == {}


def test_start_and_stop_pair():
    with pytest.raises(RuntimeError):
        tracing.stop()
    tracing.start("cpu")
    with pytest.raises(RuntimeError):
        tracing.start("cpu")
    tracing.stop()


def test_nesting_parents_ids_and_self_time():
    tracing.start()
    with tracing.span("outer", kind=_spin, step=tracing.NEXT):
        _spin(0.002)
        with tracing.span("inner", pod=0):
            _spin(0.004)
        with tracing.span("inner", pod=1):
            with tracing.span("leaf"):
                _spin(0.001)
    with tracing.span("after", step=tracing.LAST):
        pass
    with tracing.span("outer", step=tracing.NEXT):
        pass
    rec = tracing.stop()
    names = [s.name for s in rec.spans]
    assert names == ["outer", "inner", "inner", "leaf", "after", "outer"]
    assert [s.parent for s in rec.spans] == [None, 0, 0, 2, None, None]
    assert [s.index for s in rec.spans] == list(range(6))
    assert rec.spans[0].kind == "_spin" and rec.spans[1].kind is None
    assert rec.spans[1].ids == {"step": 1, "pod": 0}
    assert rec.spans[3].ids == {"step": 1, "pod": 1}       # inherited
    assert rec.spans[4].ids == {"step": 1}
    assert rec.spans[5].ids == {"step": 2}
    outer = rec.spans[0]
    kids = rec.children(outer)
    assert [k.index for k in kids] == [1, 2]
    covered = sum(k.host_end_ns - k.host_start_ns for k in kids)
    assert rec.self_ns(outer) == \
        outer.host_end_ns - outer.host_start_ns - covered
    assert rec.self_ns(outer) >= 2_000_000
    assert rec.self_ns(rec.spans[3]) == \
        rec.spans[3].host_end_ns - rec.spans[3].host_start_ns
    for s in rec.spans:
        lo, hi = rec.host_s(s)
        w0, w1 = rec.window_s()
        assert w0 <= lo <= hi <= w1
        assert s.host_start_ns <= s.host_end_ns
    assert rec.named("inner") == rec.spans[1:3]


def test_counter_deltas_and_sums():
    ticks = {"a": 10, "b": 0}

    def sample():
        return dict(ticks)
    tracing.start("cpu")
    with tracing.span("s", counters=sample):
        ticks["a"] += 3
        ticks["b"] += 1
        tracing.count("n", 2)
        with tracing.span("t", counters=lambda: {"a": ticks["a"]}):
            ticks["a"] += 5
        tracing.count("n")
    rec = tracing.stop()
    assert rec.spans[0].counters == {"a": 8, "b": 1}
    assert rec.spans[1].counters == {"a": 5}
    assert rec.counters == {"n": 3}


def test_host_clock_lands_on_the_profilers_clock():
    """``record_function`` marks made just before a span, inside it and just
    after it fall, on the profiler's clock, before the span's mapped start,
    inside its interval and after its mapped end, each to within 1 ms; and
    the clocks' offset hardly drifts between start and stop.  The order is
    causal, so a sound mapping passes however late the host runs, and one
    off by more than a millisecond either way fails."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.start("cpu")
        _spin(0.01)
        with record_function("tracing-clock-before"):
            _spin(0.002)
        with tracing.span("marked"):
            _spin(0.002)
            with record_function("tracing-clock-inside"):
                _spin(0.003)
            _spin(0.002)
        with record_function("tracing-clock-after"):
            _spin(0.002)
        _spin(0.01)
        rec = tracing.stop()
    marks = {e.name(): (e.start_ns() * 1e-9,
                        (e.start_ns() + e.duration_ns()) * 1e-9)
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("tracing-clock-")}
    lo, hi = rec.host_s(rec.spans[0])
    assert marks["tracing-clock-before"][1] <= lo + 1e-3
    m0, m1 = marks["tracing-clock-inside"]
    assert lo - 1e-3 <= m0 and m1 <= hi + 1e-3
    assert marks["tracing-clock-after"][0] >= hi - 1e-3
    assert abs(rec.offset_drift_ns) < 1_000_000


def test_no_device_events_off_cuda():
    tracing.start(torch.device("cpu"))
    with tracing.span("s"):
        torch.ones(8).sum()
    rec = tracing.stop()
    s = rec.spans[0]
    assert s.device_start_ms is None and rec.device_s(s) is None
    assert rec.device_ms(s) is None and rec.anchor_width_ns == []
    assert rec.device_scale == 1.0


def _traced(fn):
    tracing.start("cpu")
    try:
        out = fn()
    finally:
        rec = tracing.stop()
    return out, rec


def _ancestors(rec, s):
    out = []
    while s.parent is not None:
        s = rec.spans[s.parent]
        out.append(s.name)
    return out


FL_RUNS = {
    "raw/sync": dict(mode="sync"),
    "topk/async_delta": dict(mode="async", async_delta=True,
                             async_latest_table=False,
                             transport="topk_ef+int8"),
}


@pytest.mark.parametrize("run", sorted(FL_RUNS))
def test_run_fl_spans_and_bit_identical_histories(run):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    kw = dict(epochs_per_round=1, max_rounds=3, **FL_RUNS[run])
    plain = run_fl(setup, **kw)
    traced, rec = _traced(lambda: run_fl(setup, **kw))
    assert [vars(p) for p in traced] == [vars(p) for p in plain]
    names = {s.name for s in rec.spans}
    assert {"fl.event", "fl.train", "fl.encode_up", "fl.dispatch",
            "fl.encode_down", "fl.merge", "fl.eval"} <= names
    # a quantised response to a delta merge waits encoded: the merge
    # decodes it, so no decode span
    assert ("fl.decode_up" in names) == (run == "raw/sync")
    workers = {f"w{i}" for i in range(len(setup.shards))}
    for s in rec.spans:
        up = _ancestors(rec, s)
        if s.name == "fl.event":
            assert up == [] and s.kind
        elif s.name == "fl.dispatch":
            assert up in ([], ["fl.event"])     # run_fl's start, or a round
        elif s.name == "fl.encode_down":
            assert up[-1] in ("fl.event", "fl.dispatch")
        else:
            assert up[-1] == "fl.event"
        if s.name == "fl.encode_down":
            assert up[0] in ("fl.dispatch", "fl.event")
        if s.name == "fl.train" or "fl.dispatch" in up:
            assert set(s.ids) >= {"round", "worker"}
        if s.name.startswith(("fl.train", "fl.encode", "fl.decode")):
            assert s.ids["worker"] in workers
    trains = rec.named("fl.train")
    merges = rec.named("fl.merge")
    evals = rec.named("fl.eval")
    merged = sum(p.n_updates for p in traced[1:])
    # async trains on after its last merge: the trains it never merges
    assert len(trains) == merged if run == "raw/sync" else \
        len(trains) >= merged
    assert [m.ids["round"] for m in merges] == \
        [e.ids["round"] for e in evals] == list(range(len(merges)))
    assert len(merges) == len(traced) - 1


def _pods_round(compressed: bool):
    cfg = configs.get_config("musicgen-medium", reduced=True)
    opt = optim.adamw(1e-3)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    gen = torch.Generator().manual_seed(1)
    B, S = 2, 32
    batch = {"embeds": torch.randn((2 * B, S, cfg.d_model), generator=gen)
             .to(torch.bfloat16),
             "labels": torch.randint(0, cfg.vocab_size, (2 * B, S),
                                     generator=gen)}
    sp = federated.stack_for_pods(params, 2)
    so = federated.stack_for_pods(opt.init(params), 2)
    anchor = tree_map(lambda p: p[0].clone(), sp)
    comp = ErrorFeedbackCompressor(frac=0.1, quantize=True)
    w = torch.ones(2)
    losses = []
    for step in range(2):
        sp, so, met = federated.fl_local_step(sp, so, batch, cfg=cfg,
                                              optimizer=opt, n_pods=2)
        losses.append(met["loss"].clone())
        if compressed:
            sp = federated.fl_round_delta_compressed(
                sp, anchor, w, compressor=lambda d: comp.compress(d)[0])
            anchor = tree_map(lambda p: p[0].clone(), sp)
        else:
            sp = federated.fl_round(sp, w)
    return [t.clone() for t in leaves(sp)] + [t.clone() for t in leaves(so)] \
        + losses


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["fl_round", "delta_compressed"])
def test_pods_spans_and_bit_identical_state(compressed):
    plain = _pods_round(compressed)
    traced, rec = _traced(lambda: _pods_round(compressed))
    assert len(traced) == len(plain)
    for a, b in zip(traced, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    steps, merges = rec.named("pods.step"), rec.named("pods.merge")
    assert [s.ids for s in steps] == [{"step": 1}, {"step": 2}]
    assert [m.ids for m in merges] == [{"step": 1}, {"step": 2}]
    for st in steps:
        pods = rec.children(st)
        assert [p.name for p in pods] == ["pods.pod_step"] * 2
        assert [p.ids for p in pods] == [dict(st.ids, pod=i)
                                         for i in range(2)]
        for p in pods:
            assert [c.name for c in rec.children(p)] == \
                ["step.fwd_bwd", "step.optimizer", "step.grad_norm"]
            assert all(c.ids == p.ids for c in rec.children(p))
        assert st.counters == {}          # no CUDA allocator on the CPU
    want = ["merge.pack"] + (["merge.encode"] if compressed else []) + \
        ["merge.combine", "merge.unpack"]
    for m in merges:
        assert [c.name for c in rec.children(m)] == want
        assert m.parent is None


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an H100 (compute capability 9.0)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_extents_on_the_profilers_clock(card):
    """On the card every span has a device extent; the kernels launched
    inside a span run inside its extent (within 50 us), none starts before
    its span's host start, and the offset drifts under 0.1 ms."""
    a = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.start(card)
        for i in range(3):
            with tracing.span("mm", i=i):
                b = a
                for _ in range(6):
                    b = (b @ a) * 1e-3
        with tracing.span("idle"):
            pass
        rec = tracing.stop()
    kernels = sorted(
        (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation())
    assert len(kernels) >= 36
    mm = rec.named("mm")
    assert all(rec.device_ms(s) > 0 for s in mm)
    assert rec.device_ms(rec.named("idle")[0]) >= 0
    assert abs(rec.offset_drift_ns) < 100_000
    assert len(rec.anchor_width_ns) == 2
    extents = [rec.device_s(s) for s in mm]
    for s0, e0 in kernels:
        assert any(lo - 5e-5 <= s0 and e0 <= hi + 5e-5
                   for lo, hi in extents)
    for s, (lo, hi) in zip(mm, extents):
        host0 = rec.host_s(s)[0]
        assert all(k0 >= host0 for k0, _ in kernels if lo <= k0 <= hi)
