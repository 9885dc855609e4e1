"""Spans and counters of the port, recorded in memory, off by default.

Off, :func:`span` reads one module global and returns one shared no-op
context manager, and :func:`count` returns at once.  Between
:func:`start` and :func:`stop` every span is recorded with its name, its
parent (the span open when it began), the identifiers of its unit of work
(the round and the worker in FL, the step and the pod in the pods;
inherited from the parent, extended by its own), its host start and end,
and, with a CUDA ``device``, a pair of timing events recorded on the
device's current stream at entry and exit: the span's device extent.  The
events come from a pool made at :func:`start` and are read once, at
:func:`stop`, after one synchronisation, so nothing synchronises while
the recording runs.

Host times are ``time.perf_counter_ns()``; the recording maps them onto
the Unix clock in nanoseconds, the clock of ``torch.profiler``'s kineto
events, through the offset between the two clocks measured at
:func:`start` and again at :func:`stop` (linear between them; both are
kept).  Device times are anchored the same way: a reference event is
recorded on an idle device at :func:`start` and at :func:`stop`, each
between two host reads, and the events between them are placed by their
elapsed time from the first, scaled to the host's length between the two.

Usage::

    tracing.start(torch.device("cuda", 0))
    ...                                  # the program runs as usual
    rec = tracing.stop()
    for s in rec.named("step.fwd_bwd"):
        print(s.ids, rec.device_ms(s))

One recording at a time, from one thread.  No span goes inside a per-leaf
loop, a per-SGD-step loop or a kernel wrapper.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

# an id given as NEXT takes one more than the last value of that id in the
# recording (the first is 1); one given as LAST takes that last value (0
# before the first)
NEXT = object()
LAST = object()

_POOL = 256                  # timing events made at start()

_REC: Optional["Recording"] = None      # the recording in progress


class _Off:
    """The shared no-op span of tracing off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@dataclass
class Span:
    """One recorded span.  ``host_*_ns`` are ``perf_counter_ns`` readings;
    ``Recording.host_s`` and ``Recording.device_s`` put them on the
    profiler's clock."""
    name: str
    index: int                   # its place in ``Recording.spans``
    parent: Optional[int]        # the index of the span open at entry
    ids: Dict[str, object]
    kind: Optional[str]
    host_start_ns: int
    host_end_ns: int = -1
    counters: Dict[str, int] = field(default_factory=dict)
    device_start_ms: Optional[float] = None   # from the reference event
    device_end_ms: Optional[float] = None
    _events: Optional[tuple] = field(default=None, repr=False)
    _sampler: Optional[Callable[[], dict]] = field(default=None, repr=False)


def _clock_offset_ns() -> Tuple[int, int]:
    """(Unix ns − perf_counter ns, the bracket's width in ns), from the
    tightest of a few bracketed reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[1]:
            best = (u - (a + b) // 2, b - a)
    return best


class Recording:
    """What one :func:`start` … :func:`stop` recorded: ``spans`` in order of
    entry, ``counters`` summed by name, the clock offsets at either end."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[Span] = []
        self._last: Dict[str, int] = {}
        self._cuda = device is not None and device.type == "cuda"
        self._pool: list = []
        self._stream = None
        self._ref = None
        self.closed = False
        # the host brackets of the two reference events (ns; CUDA only)
        self.anchor_width_ns: List[int] = []
        if self._cuda:
            self._stream = torch.cuda.current_stream(device)
            self._pool = [torch.cuda.Event(enable_timing=True)
                          for _ in range(_POOL)]
            torch.cuda.synchronize(device)
        self.offset_start_ns, self.offset_start_width_ns = _clock_offset_ns()
        self.host_start_ns = time.perf_counter_ns()
        self.device_start_host_ns, self._ref = self._anchor()

    # -- recording ----------------------------------------------------------
    def _anchor(self) -> tuple:
        """(the host's read at the midpoint of its bracket (perf ns), the
        event) of a reference event recorded on the idle device and waited
        for, the tightest of a few; the bracket's width is kept."""
        if not self._cuda:
            return None, None
        best = None
        for _ in range(8):
            ev = torch.cuda.Event(enable_timing=True)
            a = time.perf_counter_ns()
            ev.record(self._stream)
            ev.synchronize()
            b = time.perf_counter_ns()
            if best is None or b - a < best[1] - best[0]:
                best = (a, b, ev)
        self.anchor_width_ns.append(best[1] - best[0])
        return (best[0] + best[1]) // 2, best[2]

    def _event(self):
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _enter(self, name: str, kind, counters, ids: dict) -> Span:
        parent = self._open[-1] if self._open else None
        own = {}
        for k, v in ids.items():
            if v is NEXT:
                v = self._last[k] = self._last.get(k, 0) + 1
            elif v is LAST:
                v = self._last.get(k, 0)
            own[k] = v
        if kind is not None and not isinstance(kind, str):
            kind = getattr(kind, "__qualname__", None) or \
                type(kind).__qualname__
        s = Span(name, len(self.spans), None if parent is None
                 else parent.index,
                 dict(parent.ids, **own) if parent is not None else own,
                 kind, 0)
        if counters is not None:
            s._sampler = counters
            s.counters = counters()
        self.spans.append(s)
        self._open.append(s)
        # the host start before the device's event, the device's end event
        # before the host end: the device extent's work was launched inside
        # the host interval
        s.host_start_ns = time.perf_counter_ns()
        if self._cuda:
            s._events = (self._event(), None)
        return s

    def _exit(self, s: Span) -> None:
        if self._cuda:
            s._events = (s._events[0], self._event())
        s.host_end_ns = time.perf_counter_ns()
        if s._sampler is not None:
            end = s._sampler()
            s.counters = {k: end[k] - v for k, v in s.counters.items()
                          if k in end}
            s._sampler = None
        if self._open and self._open[-1] is s:
            self._open.pop()
        elif s in self._open:
            self._open.remove(s)

    def _finish(self) -> None:
        self.host_stop_ns = time.perf_counter_ns()
        self.device_stop_host_ns = None
        if self._cuda:
            torch.cuda.synchronize(self.device)
            self.device_stop_host_ns, ref_end = self._anchor()
            for s in self.spans:
                if s._events is not None and s._events[1] is not None:
                    s.device_start_ms = self._ref.elapsed_time(s._events[0])
                    s.device_end_ms = self._ref.elapsed_time(s._events[1])
                s._events = None
            self.device_span_ms = self._ref.elapsed_time(ref_end)
            self._ref = None
        self.offset_stop_ns, self.offset_stop_width_ns = _clock_offset_ns()
        self._pool = []
        self._open = []
        self.closed = True

    # -- reading ------------------------------------------------------------
    @property
    def offset_drift_ns(self) -> int:
        """How far the host clocks' offset moved between start and stop."""
        return self.offset_stop_ns - self.offset_start_ns

    def to_clock_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the profiler's (Unix) clock."""
        span = max(self.host_stop_ns - self.host_start_ns, 1)
        f = (perf_ns - self.host_start_ns) / span
        return perf_ns + self.offset_start_ns + round(
            f * self.offset_drift_ns)

    def window_s(self) -> Tuple[float, float]:
        """The recording's own bounds, seconds on the profiler's clock."""
        return (self.to_clock_ns(self.host_start_ns) * 1e-9,
                self.to_clock_ns(self.host_stop_ns) * 1e-9)

    def host_s(self, s: Span) -> Tuple[float, float]:
        """The span's host interval, seconds on the profiler's clock."""
        return (self.to_clock_ns(s.host_start_ns) * 1e-9,
                self.to_clock_ns(s.host_end_ns) * 1e-9)

    @property
    def device_scale(self) -> float:
        """Host ns per device ns between the two reference events (1 off
        CUDA)."""
        if not self._cuda or not self.device_span_ms:
            return 1.0
        host = self.device_stop_host_ns - self.device_start_host_ns
        return host / (self.device_span_ms * 1e6)

    def device_s(self, s: Span) -> Optional[Tuple[float, float]]:
        """The span's device extent, seconds on the profiler's clock, or
        None without device events."""
        if s.device_start_ms is None:
            return None
        k = self.device_scale
        return tuple(self.to_clock_ns(self.device_start_host_ns + round(
            ms * 1e6 * k)) * 1e-9 for ms in (s.device_start_ms,
                                             s.device_end_ms))

    def device_ms(self, s: Span) -> Optional[float]:
        """The span's device extent's length in ms, or None."""
        if s.device_start_ms is None:
            return None
        return s.device_end_ms - s.device_start_ms

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, s: Span) -> List[Span]:
        return [c for c in self.spans if c.parent == s.index]

    def self_ns(self, s: Span) -> int:
        """The span's host duration less the part its children cover."""
        cover, end = 0, s.host_start_ns
        for c in sorted(self.children(s), key=lambda c: c.host_start_ns):
            a, b = max(c.host_start_ns, end), min(c.host_end_ns,
                                                  s.host_end_ns)
            if b > a:
                cover += b - a
            end = max(end, c.host_end_ns)
        return s.host_end_ns - s.host_start_ns - cover


class _On:
    """A span of tracing on."""
    __slots__ = ("rec", "args", "span")

    def __init__(self, rec: Recording, args: tuple):
        self.rec, self.args = rec, args

    def __enter__(self) -> Span:
        self.span = self.rec._enter(*self.args)
        return self.span

    def __exit__(self, *exc):
        if not self.rec.closed:
            self.rec._exit(self.span)
        return False


def span(name: str, kind=None, counters: Optional[Callable[[], dict]] = None,
         **ids):
    """A context manager around one layer's call.  ``kind`` labels the
    span (a function is recorded by its ``__qualname__``); ``counters``, a
    function returning a dict of running counts, is read at entry and exit
    and the span keeps the deltas; ``ids`` name its unit of work (see
    ``NEXT`` and ``LAST``).  Off, the shared no-op."""
    rec = _REC
    if rec is None:
        return _OFF
    return _On(rec, (name, kind, counters, ids))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording in progress."""
    rec = _REC
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def counts(names) -> dict:
    """The counters ``names`` of the recording in progress, 0 where not
    yet counted (a span's ``counters`` sampler); nothing when off."""
    rec = _REC
    if rec is None:
        return {}
    return {n: rec.counters.get(n, 0) for n in names}


def alloc_counters() -> dict:
    """The caching allocator's device frees (each ``cudaFree``
    synchronises the device), allocation retries and device allocations
    (``cudaMalloc``) so far on the recording's CUDA device:
    ``alloc.device_frees``, ``alloc.retries``, ``alloc.device_allocs``
    (nothing elsewhere)."""
    rec = _REC
    if rec is None or not rec._cuda:
        return {}
    st = torch.cuda.memory_stats(rec.device)
    return {name: st[key] for name, key in (
        ("alloc.device_frees", "num_device_free"),
        ("alloc.retries", "num_alloc_retries"),
        ("alloc.device_allocs", "num_device_alloc")) if key in st}


def start(device=None) -> None:
    """Begin a recording.  With a CUDA ``device`` spans also record their
    device extents there (the device is synchronised once, here)."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a tracing recording is already in progress")
    _REC = Recording(None if device is None else torch.device(device))


def stop() -> Recording:
    """End the recording in progress (one synchronisation of its CUDA
    device) and return it."""
    global _REC
    rec = _REC
    if rec is None:
        raise RuntimeError("no tracing recording is in progress")
    _REC = None
    rec._finish()
    return rec
