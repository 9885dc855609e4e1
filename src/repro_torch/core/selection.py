"""Worker-selection algorithms (thesis §3.4).

Algorithm 1 — R-min/R-max:
    T_min_w = T_one_w * rmin + T_transmit_w
    T_max_w = T_one_w * rmax + T_transmit_w
    T_minimum = min_w T_max_w
    selected = { w : T_min_w <= T_minimum }
  with post-round updates (eqs 3.1/3.2):
    rmin *= (acc_{n-1} + 1) / (acc_n + 1)       # shrinks as accuracy grows
    rmax *= (acc_n + 1) / (acc_{n-1} + 1)       # grows as accuracy grows

  (the thesis text: decreasing rmin while increasing rmax lets slow workers
  join as training progresses; mis-initialisation stalls training — fig 4.5 —
  which our reproduction demonstrates.)

Algorithm 2 — training-time based:
    T_total_w = T_one_w * r + T_transmit_w
    selected = { w : T_total_w <= T }
  with eq 3.3: if accuracy gain < A, raise T to the smallest T_total among
  the not-yet-selected workers (admitting at least one more).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from .estimator import TimeEstimator, WorkerProfile
from .population import as_view

# the T_transmit term of the time budget is priced per *expected wire
# bytes*: a plain int (the thesis' full model size) or a zero-arg callable
# (the transport layer's expected codec'd round-trip — the mean of the
# up- and downlink codecs' expected bytes, evaluated per select so
# compressed codecs in either direction admit slow-link workers earlier)
BytesSpec = Union[int, Callable[[], int]]


def _resolve_bytes(model_bytes: BytesSpec) -> int:
    return int(model_bytes()) if callable(model_bytes) else int(model_bytes)


def _note_scores(workers, scores: Dict[str, float]) -> None:
    """Mirror per-object eq-3.4 prices into any bound population ``score``
    lane — the per-object fallback paths must leave the lanes exactly as
    the vectorized paths would, or the lanes go stale whenever a caller
    hands the selector a plain profile list (parity pinned in
    tests/test_scale.py)."""
    for w in workers:
        s = scores.get(w.worker_id)
        if s is None:
            continue
        for ref, lane in w.__dict__.get("_bindings", ()):
            pop = ref()
            if pop is not None:
                pop.score[lane] = s


def _alive_ids(workers) -> List[str]:
    """Worker ids of the alive subset — one vectorized mask over the lane
    arrays for a ``PopulationView``, the per-object scan for plain lists.
    Both paths return ids in ``workers`` order, so downstream seeded
    sampling draws identically whichever path ran."""
    view = as_view(workers)
    if view is not None:
        return view.ids_where(view.alive_mask())
    return [w.worker_id for w in workers if not w.failed]


class Selector:
    name = "base"

    def select(self, workers: Sequence[WorkerProfile]) -> List[str]:
        raise NotImplementedError

    def on_round_end(self, accuracy: float) -> None:
        pass


class AllSelector(Selector):
    name = "all"

    def select(self, workers):
        return _alive_ids(workers)


class RandomSelector(Selector):
    """The thesis' random-selection baseline (fig 4.3)."""
    name = "random"

    def __init__(self, k: int, seed: int = 0):
        self.k = k
        self.rng = random.Random(seed)

    def select(self, workers):
        alive = _alive_ids(workers)
        k = min(self.k, len(alive))
        return self.rng.sample(alive, k)


class RMinRMaxSelector(Selector):
    """Algorithm 1."""
    name = "rmin_rmax"

    def __init__(self, estimator: TimeEstimator, model_bytes: BytesSpec,
                 rmin: float = 5.0, rmax: float = 5.0):
        self.est = estimator
        self.model_bytes = model_bytes
        self.rmin = float(rmin)
        self.rmax = float(rmax)
        self._last_acc = 0.0
        self._pending_bytes = None    # BytesSpec resolved at last select

    def select(self, workers):
        # one BytesSpec resolution per select, pinned on the instance so
        # round-end re-pricing can never see different bytes than the
        # select that produced the round (a time-varying BytesSpec — the
        # auto codec's expected_oneway_bytes — may change between calls)
        nbytes = self._pending_bytes = _resolve_bytes(self.model_bytes)
        view = as_view(workers)
        if view is not None:
            # fused vector pass: eq 3.4 priced for every alive lane at
            # once (bit-identical to the scalar scan — float64 lanes,
            # same per-lane op order, and np.min/<= are exact)
            alive = view.where(view.alive_mask())
            if not len(alive):
                return []
            t_one = self.est.t_one_vec(alive)
            t_tx = self.est.t_transmit_vec(alive, nbytes)
            t_min = t_one * self.rmin + t_tx
            t_max = t_one * self.rmax + t_tx
            alive.pop.score[alive.lanes] = t_min
            return alive.ids_where(t_min <= np.min(t_max))
        alive = [w for w in workers if not w.failed]
        if not alive:
            return []
        t_min = {w.worker_id: self.est.t_one(w) * self.rmin +
                 self.est.t_transmit(w, nbytes) for w in alive}
        t_max = {w.worker_id: self.est.t_one(w) * self.rmax +
                 self.est.t_transmit(w, nbytes) for w in alive}
        _note_scores(alive, t_min)       # lane/object parity with the
        t_minimum = min(t_max.values())  # vector path's score write
        return [w.worker_id for w in alive if t_min[w.worker_id] <= t_minimum]

    def on_round_end(self, accuracy):  # eqs 3.1 / 3.2
        prev, cur = self._last_acc, accuracy
        self.rmin *= (prev + 1.0) / (cur + 1.0)
        self.rmax *= (cur + 1.0) / (prev + 1.0)
        self._last_acc = accuracy


class TimeBasedSelector(Selector):
    """Algorithm 2 (the thesis' winning policy)."""
    name = "time_based"

    def __init__(self, estimator: TimeEstimator, model_bytes: BytesSpec,
                 r: int = 10, T0: float = 0.0, accuracy_threshold: float = 0.01):
        self.est = estimator
        self.model_bytes = model_bytes
        self.r = r
        self.T = float(T0)
        self.A = accuracy_threshold
        self._last_acc = 0.0
        self._last_selected: List[str] = []
        self._pending_bytes = None    # BytesSpec resolved at last select

    def _t_total(self, w: WorkerProfile, nbytes: int) -> float:
        return self.est.t_one(w) * self.r + self.est.t_transmit(w, nbytes)

    def _t_total_vec(self, view, nbytes: int) -> np.ndarray:
        return self.est.t_one_vec(view) * self.r + \
            self.est.t_transmit_vec(view, nbytes)

    def select(self, workers):
        # resolve the BytesSpec ONCE per select and pin it: the eq-3.3
        # round-end raise must price against the same bytes as the select
        # that produced ``_pending`` — re-resolving there would let a
        # time-varying BytesSpec (the auto codec's schedule) admit against
        # one byte count and raise the budget against another
        nbytes = self._pending_bytes = _resolve_bytes(self.model_bytes)
        view = as_view(workers)
        if view is not None:
            alive = view.where(view.alive_mask())
            t_total = self._t_total_vec(alive, nbytes)
            alive.pop.score[alive.lanes] = t_total
            selmask = t_total <= self.T
            sel = alive.ids_where(selmask)
            self._pending = alive
            self._pending_selmask = selmask
            self._last_selected = sel
            return sel
        alive = [w for w in workers if not w.failed]
        t_total = {w.worker_id: self._t_total(w, nbytes) for w in alive}
        _note_scores(alive, t_total)   # lane/object parity (vector path)
        sel = [w.worker_id for w in alive if t_total[w.worker_id] <= self.T]
        self._pending = alive
        self._pending_selmask = None
        self._last_selected = sel
        return sel

    def on_round_end(self, accuracy):   # eq 3.3
        gain = accuracy - self._last_acc
        if gain < self.A:
            pending = getattr(self, "_pending", [])
            selmask = getattr(self, "_pending_selmask", None)
            # the bytes pinned by the select that produced _pending —
            # NEVER re-resolved here (see select)
            nbytes = self._pending_bytes
            if nbytes is None:
                nbytes = _resolve_bytes(self.model_bytes)
            if selmask is not None:
                # same eq-3.3 raise, fused: re-price the not-selected
                # lanes with the estimator's CURRENT measurements (the
                # scalar path recomputes _t_total at round end too)
                if not np.all(selmask):
                    self.T = float(np.min(
                        self._t_total_vec(pending.where(~selmask), nbytes)))
            else:
                not_sel = [w for w in pending
                           if w.worker_id not in self._last_selected]
                if not_sel:
                    self.T = min(self._t_total(w, nbytes) for w in not_sel)
        self._last_acc = accuracy


def make_pool_selectors(kind: str, estimators: Sequence[TimeEstimator],
                        bytes_specs: Sequence[BytesSpec],
                        **kw) -> List[Selector]:
    """One independently-stateful selector per leaf worker pool (multi-
    server topologies, core/topology.py).  Every policy except ``all`` is
    stateful — rmin/rmax feedback, the eq-3.3 time budget — so pools must
    never share an instance: each leaf's budget evolves with its OWN
    accuracy trajectory and its own pool's estimator, exactly as a
    single-server run's would."""
    if len(estimators) != len(bytes_specs):
        raise ValueError("one estimator and bytes-spec per pool")
    return [make_selector(kind, est, bs, **kw)
            for est, bs in zip(estimators, bytes_specs)]


def make_selector(kind: str, estimator: TimeEstimator,
                  model_bytes: BytesSpec, **kw) -> Selector:
    if kind == "all":
        return AllSelector()
    if kind == "random":
        return RandomSelector(k=kw.get("k", 3), seed=kw.get("seed", 0))
    if kind == "rmin_rmax":
        return RMinRMaxSelector(estimator, model_bytes,
                                rmin=kw.get("rmin", 5.0),
                                rmax=kw.get("rmax", 5.0))
    if kind == "time_based":
        return TimeBasedSelector(estimator, model_bytes,
                                 r=kw.get("r", 10),
                                 T0=kw.get("T0", 0.0),
                                 accuracy_threshold=kw.get("A", 0.01))
    raise ValueError(kind)
