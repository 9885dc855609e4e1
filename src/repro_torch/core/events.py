"""Deterministic discrete-event engine.

The thesis evaluates FL by wall-clock time-to-accuracy on four heterogeneous
VMs. Inside one CPU container that heterogeneity cannot physically exist, so
every paper experiment runs in *simulated time*: training and transmission
durations come from the same system statistics FogBus2's profiler exposes
(CPU frequency x availability, data size, link bandwidth), while the actual
numerics (the workers' PyTorch training steps, the codecs and the merges)
execute for real. The engine is deterministic: ties break by sequence
number, never by wall clock.  With tracing on (``repro_torch.tracing``)
every executed event is an ``fl.event`` span labelled by its callback.

Cancellation is lazy: :meth:`EventLoop.schedule` returns the queued
:class:`_Event` as a handle, :meth:`EventLoop.cancel` flags it dead
(removing an arbitrary heap entry would be O(n)), and :meth:`run` skips
dead entries as they surface.  Dead entries are compacted out of the heap
whenever they exceed half of it, so a retransmit-heavy large-population
run (every delivered payload cancels its pending ack-timeout) keeps the
queue proportional to the LIVE event count instead of growing without
bound.  Cancelling consumes no sequence numbers and never reorders live
events, so a run with cancellations is event-order-identical to one where
the dead entries fired as no-ops.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch import tracing

# compaction floor: below this many dead entries the rebuild costs more
# than the heap overhead it reclaims
_COMPACT_MIN = 64


@dataclass(order=True, slots=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())
    cancelled: bool = field(compare=False, default=False)


class EventLoop:
    def __init__(self):
        self._q: list[_Event] = []
        self._seq = itertools.count()
        self._n_cancelled = 0
        self.now = 0.0
        self._stopped = False
        # True iff the last run() returned because max_events was hit
        # with work still queued — the run is TRUNCATED, not complete,
        # and callers must not treat the history as valid
        self.exhausted = False
        # events executed by the last run() — lets a segmented caller
        # (checkpoint/resume) account max_events across run() calls
        self.events_run = 0

    def schedule(self, delay: float, fn: Callable, *args) -> _Event:
        assert delay >= 0, delay
        ev = _Event(self.now + delay, next(self._seq), fn, args)
        heapq.heappush(self._q, ev)
        return ev

    def at(self, time: float, fn: Callable, *args) -> _Event:
        return self.schedule(max(0.0, time - self.now), fn, *args)

    def schedule_abs(self, time: float, fn: Callable, *args) -> _Event:
        """Schedule at an EXACT absolute timestamp.  ``schedule(t - now)``
        re-derives the deadline as ``now + (t - now)``, which can differ
        from ``t`` by an ulp; checkpoint resume replays serialized events
        through this method so restored deadlines are bit-identical to the
        ones the uninterrupted run would have fired."""
        ev = _Event(max(time, self.now), next(self._seq), fn, args)
        heapq.heappush(self._q, ev)
        return ev

    def call_soon(self, fn: Callable, *args) -> _Event:
        """Run ``fn`` at the current simulated time, but AFTER the call
        stack and any already-queued events at this timestamp (ties break
        by sequence number).  The topology layer uses this to settle
        same-instant leaf events — e.g. a leaf finishing and pushing in
        the same aggregate — before acting on their combined state."""
        return self.schedule(0.0, fn, *args)

    def cancel(self, ev: Optional[_Event]) -> None:
        """Flag a scheduled event dead (idempotent; None is a no-op).  The
        heap entry is skipped by :meth:`run` and reclaimed by compaction."""
        if ev is None or ev.cancelled:
            return
        ev.cancelled = True
        self._n_cancelled += 1
        if self._n_cancelled > _COMPACT_MIN \
                and 2 * self._n_cancelled > len(self._q):
            self._q = [e for e in self._q if not e.cancelled]
            heapq.heapify(self._q)
            self._n_cancelled = 0

    def stop(self) -> None:
        self._stopped = True

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000,
            break_when: Optional[Callable[[], bool]] = None):
        """Drain the queue.  ``break_when`` (checked after every executed
        event) returns True to pause the loop at a consistent boundary —
        the checkpoint loop uses it to stop exactly when a round closes.
        A paused loop is neither stopped nor exhausted; calling :meth:`run`
        again continues from the same state."""
        n = 0
        self.exhausted = False
        while self._q and not self._stopped and n < max_events:
            ev = heapq.heappop(self._q)
            if until is not None and ev.time > until:
                heapq.heappush(self._q, ev)
                break
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            self.now = ev.time
            with tracing.span("fl.event", kind=ev.fn):
                ev.fn(*ev.args)
            n += 1
            if break_when is not None and break_when():
                break
        self.exhausted = bool(self._q) and not self._stopped \
            and n >= max_events
        self.events_run = n
        return self.now
