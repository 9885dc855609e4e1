"""Vectorized per-worker control-plane state (the population layer).

The thesis demonstrates worker selection at a handful of FogBus2 workers;
the ROADMAP north-star is serving orders of magnitude more.  At W≈10⁴ a
per-object scan over worker profiles per selection round — the
``t_compute``/``t_transmit`` dict comprehensions of ``selection.py`` — is
the control-plane bottleneck, so this module batches every per-worker
scalar the control plane reads into ``(W,)`` numpy vectors with one lane
per worker:

  * profile statistics (CPU freq/prop, bandwidth, batch counts, the
    ``failed`` fault flag) — kept in sync with the ``WorkerProfile``
    objects by an adoption hook, so code that mutates a profile directly
    (fault injectors, tests) transparently updates the lane;
  * measured estimator feedback (``t_one`` / transmit-bandwidth samples,
    NaN = not yet measured), written by ``TimeEstimator.observe_*``;
  * bookkeeping the server streams per response: last acked model
    version, last staleness, last selection score, EF-residual norms.

All float lanes are float64: numpy float64 elementwise ops are the same
IEEE-754 double operations CPython performs on scalar floats, so the
vectorized eq-3.4 pricing in ``TimeEstimator.t_one_vec`` /
``t_transmit_vec`` is bit-identical to the per-object scalar path as
long as the operation ORDER per lane is preserved — which the selection
policies rely on to keep the golden histories pinned.

Lanes are append-only: a worker that leaves keeps its lane (marked
unregistered) and re-joining re-registers the same lane, so lane indices
are stable handles for the chaos layer (``FaultInjector.kill_lane_at``
kills by lane — including workers no link/event state has ever been
materialized for).  Profiles hold their populations by weakref, so a
profile adopted by successive runs never keeps a dead run's arrays
alive.

:class:`PopulationView` is a lane-indexed window (a ``Sequence`` of
``WorkerProfile``, so every legacy consumer of ``server.profiles()``
keeps working) that the selectors detect via :func:`as_view` to take the
fused vector path; plain profile lists fall back to the per-object scan.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.parallel import sharding as psh

from .estimator import TimeEstimator, WorkerProfile

_GROW = 64          # lane-array growth quantum


class WorkerPopulation:
    """Batched ``(W,)`` control-plane state, one lane per adopted worker."""

    def __init__(self):
        self._ids: List[str] = []
        self._lane_of: Dict[str, int] = {}
        self._profiles: List[WorkerProfile] = []
        self._est: Optional[TimeEstimator] = None
        self._cap = 0
        self.size = 0
        # profile mirror lanes (synced by WorkerProfile.__setattr__)
        self.cpu_freq = np.zeros(0)
        self.cpu_prop = np.zeros(0)
        self.bandwidth = np.zeros(0)
        self.n_batches = np.zeros(0)
        self.failed = np.zeros(0, bool)
        self.registered = np.zeros(0, bool)
        # estimator measurement lanes (NaN = not yet measured)
        self.t_one_meas = np.zeros(0)
        self.tx_t = np.zeros(0)
        self.tx_bytes = np.zeros(0)
        # per-response bookkeeping lanes (server streams these)
        self.ack_version = np.zeros(0, np.int64)
        self.staleness = np.zeros(0, np.int64)
        self.score = np.zeros(0)        # last eq-3.4 selection score
        self.ef_norm = np.zeros(0)      # last snapshotted uplink-EF norm

    # --- lane management ---
    def _grow_to(self, n: int):
        if n <= self._cap:
            return
        cap = max(n, self._cap + _GROW)
        pad = cap - self._cap

        def ext(a, fill=0.0):
            return np.concatenate([a, np.full(pad, fill, a.dtype)])
        self.cpu_freq = ext(self.cpu_freq)
        self.cpu_prop = ext(self.cpu_prop)
        self.bandwidth = ext(self.bandwidth)
        self.n_batches = ext(self.n_batches)
        self.failed = ext(self.failed, False)
        self.registered = ext(self.registered, False)
        self.t_one_meas = ext(self.t_one_meas, np.nan)
        self.tx_t = ext(self.tx_t, np.nan)
        self.tx_bytes = ext(self.tx_bytes, np.nan)
        self.ack_version = ext(self.ack_version, -1)
        self.staleness = ext(self.staleness, 0)
        self.score = ext(self.score, np.nan)
        self.ef_norm = ext(self.ef_norm, 0.0)
        self._cap = cap

    def adopt(self, profile: WorkerProfile) -> int:
        """Assign (or re-register) a lane for ``profile`` and bind the
        profile to it: every later direct mutation of the profile object
        (``p.failed = True`` from a fault injector or test) forwards into
        the lane arrays, so the vectors can never go stale."""
        wid = profile.worker_id
        lane = self._lane_of.get(wid)
        if lane is None:
            lane = self.size
            self.size += 1
            self._grow_to(self.size)
            self._ids.append(wid)
            self._lane_of[wid] = lane
            self._profiles.append(profile)
        else:
            self._profiles[lane] = profile
        self.cpu_freq[lane] = profile.cpu_freq
        self.cpu_prop[lane] = profile.cpu_prop
        self.bandwidth[lane] = profile.bandwidth
        self.n_batches[lane] = profile.n_batches
        self.failed[lane] = profile.failed
        self.registered[lane] = True
        est = self._est
        if est is not None:          # backfill measurements observed
            v = est._measured_t_one.get(wid)          # before adoption
            if v is not None:
                self.t_one_meas[lane] = v
            m = est._measured_tx.get(wid)
            if m is not None:
                self.tx_t[lane], self.tx_bytes[lane] = m[0], float(m[1])
        bindings = profile.__dict__.setdefault("_bindings", [])
        if not any(r() is self for r, _ in bindings):
            bindings.append((weakref.ref(self), lane))
        return lane

    def release(self, worker_id: str) -> None:
        """The worker left (elastic scale-down): keep the lane — lane
        indices are stable chaos handles — but drop it from every
        registered/alive mask until a re-adopt."""
        lane = self._lane_of.get(worker_id)
        if lane is not None:
            self.registered[lane] = False

    def lane(self, worker_id: str) -> int:
        return self._lane_of[worker_id]

    def worker_id(self, lane: int) -> str:
        return self._ids[lane]

    def profile(self, lane: int) -> WorkerProfile:
        return self._profiles[lane]

    def __len__(self) -> int:
        return self.size

    # --- sync hooks ---
    def _on_profile_set(self, lane: int, name: str, value) -> None:
        getattr(self, name)[lane] = value

    def bind_estimator(self, est: TimeEstimator) -> None:
        self._est = est
        for lane, wid in enumerate(self._ids):
            v = est._measured_t_one.get(wid)
            if v is not None:
                self.t_one_meas[lane] = v
            m = est._measured_tx.get(wid)
            if m is not None:
                self.tx_t[lane], self.tx_bytes[lane] = m[0], float(m[1])

    def note_t_one(self, worker_id: str, t_one: float) -> None:
        lane = self._lane_of.get(worker_id)
        if lane is not None:
            self.t_one_meas[lane] = t_one

    def note_tx(self, worker_id: str, t_tx: float, n_bytes: int) -> None:
        lane = self._lane_of.get(worker_id)
        if lane is not None:
            self.tx_t[lane] = t_tx
            self.tx_bytes[lane] = float(n_bytes)

    def note_response(self, worker_id: str, base_version: int,
                      staleness: int) -> None:
        lane = self._lane_of.get(worker_id)
        if lane is not None:
            self.ack_version[lane] = base_version
            self.staleness[lane] = staleness

    def snapshot_ef_norms(self, transport) -> np.ndarray:
        """Record the L2 norm of each RESIDENT link's uplink EF residual
        into the ``ef_norm`` lanes (cost O(active cohort), never O(W) —
        evicted/never-contacted workers keep their last value) and return
        the full lane vector."""
        for wid, link in transport._links.items():
            lane = self._lane_of.get(wid)
            if lane is not None and link.residual is not None:
                # a sharded link's residual gathered first: one norm over
                # the whole vector gives the unsharded run's bits
                r = link.residual
                if isinstance(r, psh.Sharded):
                    r = r.gather()
                self.ef_norm[lane] = float(np.linalg.norm(np.asarray(
                    r.cpu())))
        return self.ef_norm[:self.size]

    # --- views ---
    def view(self, lanes) -> "PopulationView":
        return PopulationView(self, np.asarray(lanes, np.intp))

    def view_for(self, worker_ids: Iterable[str]) -> "PopulationView":
        """View over the given ids, in the given order (the server passes
        its registry dict, so view order == legacy ``profiles()`` order)."""
        ids = list(worker_ids)
        lanes = np.fromiter((self._lane_of[w] for w in ids),
                            dtype=np.intp, count=len(ids))
        return PopulationView(self, lanes)

    def view_all(self) -> "PopulationView":
        return PopulationView(self, np.arange(self.size, dtype=np.intp))


class PopulationView(Sequence):
    """Lane-indexed window into a population.  Iterates as a sequence of
    ``WorkerProfile`` (legacy consumers), while the selectors read the
    ``(k,)`` lane vectors through it for the fused pricing pass."""

    __slots__ = ("pop", "lanes")

    def __init__(self, pop: WorkerPopulation, lanes: np.ndarray):
        self.pop = pop
        self.lanes = lanes

    def __len__(self) -> int:
        return len(self.lanes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PopulationView(self.pop, self.lanes[i])
        return self.pop._profiles[self.lanes[i]]

    def alive_mask(self) -> np.ndarray:
        """registered & not failed, over this view's lanes."""
        p, l = self.pop, self.lanes
        return p.registered[l] & ~p.failed[l]

    def where(self, mask) -> "PopulationView":
        return PopulationView(self.pop, self.lanes[np.asarray(mask, bool)])

    def worker_ids(self) -> List[str]:
        ids = self.pop._ids
        return [ids[l] for l in self.lanes]

    def ids_where(self, mask) -> List[str]:
        ids = self.pop._ids
        return [ids[l] for l in self.lanes[np.asarray(mask, bool)]]


def as_view(workers) -> Optional[PopulationView]:
    """The population view behind a ``select()`` argument, or None when it
    is a plain profile sequence (the per-object scalar path)."""
    if isinstance(workers, PopulationView):
        return workers
    if isinstance(workers, WorkerPopulation):
        return workers.view_all()
    return None
