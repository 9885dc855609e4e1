"""Training/transmission time estimation (thesis §3.4.4, eq 3.4).

``T_one <- T_onedata / CPU_freq_server * CPU_freq_w * CPU_prop_w * N_w``

(the thesis' multiplier semantics: a worker's per-batch time scales with the
server-measured per-batch time by the ratio of *effective* CPU throughputs;
here the effective throughput is freq*availability, so the per-batch time
multiplies by ``server_freq / (freq_w * prop_w)``; eq 3.4 writes the product
form of the same heuristic).

Transmission time is *measured*, not profiled — the thesis transmits the
randomly-initialised weights once to each worker because its FL channel is
separate from FogBus2's (§3.4.4). ``observe_transmit`` mirrors that, but
stores the measurement as a *bandwidth* (measured seconds per measured
byte): with the transport layer's codecs the payload size varies per
direction and per codec, so a fixed measured time would mis-estimate every
transfer whose size differs from the first one. ``t_transmit`` scales the
measured time by ``requested_bytes / measured_bytes`` — for a request of
exactly the measured size this returns the measured time bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# profile fields mirrored into WorkerPopulation lane arrays (population.py)
_POP_SYNCED = frozenset(
    {"cpu_freq", "cpu_prop", "bandwidth", "n_batches", "failed"})


@dataclass
class WorkerProfile:
    """System statistics the FogBus2 Profiler exposes per worker."""
    worker_id: str
    cpu_freq: float = 2.0        # GHz
    cpu_prop: float = 1.0        # available fraction of the CPU
    bandwidth: float = 100e6     # bytes/s on the weight-transfer channel
    n_batches: int = 1           # batches of training data held (tables 4.1/4.2)
    failed: bool = False         # fault-injection flag (node failure)

    def __setattr__(self, name, value):
        # adoption hook (population.py): a profile adopted into a
        # WorkerPopulation forwards direct mutations (fault injectors and
        # tests write ``p.failed = True`` on the object) into its lane, so
        # the vectorized control plane can never go stale.  Populations
        # are held by weakref — a profile adopted by successive runs must
        # not keep a dead run's arrays alive.
        object.__setattr__(self, name, value)
        if name not in _POP_SYNCED:
            return
        bindings = self.__dict__.get("_bindings")
        if not bindings:
            return
        dead = False
        for ref, lane in bindings:
            pop = ref()
            if pop is None:
                dead = True
            else:
                pop._on_profile_set(lane, name, value)
        if dead:
            self.__dict__["_bindings"] = [
                (r, l) for r, l in bindings if r() is not None]


class TimeEstimator:
    def __init__(self, server_freq: float = 3.0,
                 t_onebatch_server: float = 0.05):
        # T_onedata measured by the aggregation server training one batch
        self.server_freq = server_freq
        self.t_onebatch_server = t_onebatch_server
        # measured values override estimates once a worker has responded
        self._measured_t_one: Dict[str, float] = {}
        # worker -> (measured seconds, measured bytes): a bandwidth sample
        self._measured_tx: Dict[str, Tuple[float, int]] = {}
        # optional WorkerPopulation mirror: observe_* writes the lane
        # arrays too, so the vectorized pricing below never goes stale
        self._pop = None

    def bind_population(self, pop) -> None:
        """Mirror every measurement into ``pop``'s lane arrays (and
        backfill lanes for anything already measured)."""
        self._pop = pop
        pop.bind_estimator(self)

    # --- eq 3.4 ---
    def t_one(self, p: WorkerProfile) -> float:
        """Time for worker to train ONE epoch over its whole local data."""
        if p.worker_id in self._measured_t_one:
            return self._measured_t_one[p.worker_id]
        per_batch = self.t_onebatch_server * self.server_freq / \
            max(p.cpu_freq * p.cpu_prop, 1e-9)
        return per_batch * max(p.n_batches, 0)

    def t_transmit(self, p: WorkerProfile, model_bytes: int) -> float:
        """Estimated seconds to move ``model_bytes`` over the worker's link:
        measured bandwidth once a transfer has been observed, the profile's
        nominal bandwidth before that. Always linear in the payload size."""
        m = self._measured_tx.get(p.worker_id)
        if m is not None:
            t_meas, bytes_meas = m
            return t_meas * (model_bytes / max(bytes_meas, 1))
        return model_bytes / max(p.bandwidth, 1.0)

    # --- eq 3.4, fused over a population view ---
    # Bit-identical to the scalar methods above: float64 numpy elementwise
    # ops are the same IEEE-754 doubles CPython computes on scalars, and
    # the per-lane operation ORDER matches the scalar expressions exactly
    # (pinned by the golden histories, which run the vector path).
    def t_one_vec(self, view) -> np.ndarray:
        """:meth:`t_one` for every lane of a ``PopulationView`` at once."""
        pop, l = view.pop, view.lanes
        per_batch = self.t_onebatch_server * self.server_freq / \
            np.maximum(pop.cpu_freq[l] * pop.cpu_prop[l], 1e-9)
        est = per_batch * np.maximum(pop.n_batches[l], 0)
        meas = pop.t_one_meas[l]
        return np.where(np.isnan(meas), est, meas)

    def t_transmit_vec(self, view, model_bytes: int) -> np.ndarray:
        """:meth:`t_transmit` for every lane of a view at once (measured
        bandwidth where a transfer has been observed, nominal otherwise)."""
        pop, l = view.pop, view.lanes
        t_meas = pop.tx_t[l]
        measured = t_meas * (model_bytes / np.maximum(pop.tx_bytes[l], 1))
        nominal = model_bytes / np.maximum(pop.bandwidth[l], 1.0)
        return np.where(np.isnan(t_meas), nominal, measured)

    def bandwidth(self, worker_id: str) -> Optional[float]:
        """Measured bytes/s for a worker, or None before any observation."""
        m = self._measured_tx.get(worker_id)
        if m is None:
            return None
        t_meas, bytes_meas = m
        return bytes_meas / max(t_meas, 1e-12)

    def median_bandwidth(self) -> Optional[float]:
        """Median measured bytes/s across all observed workers, or None
        before any observation — the transport-wide representative rate
        the auto codec tuner prices selection byte estimates at."""
        if not self._measured_tx:
            return None
        rates = [b / max(t, 1e-12) for t, b in self._measured_tx.values()]
        return float(np.median(rates))

    # --- measurement feedback (thesis: 'after any worker ... the actual
    # time consumed for communication and training is updated') ---
    def observe_training(self, worker_id: str, t_one_measured: float):
        self._measured_t_one[worker_id] = t_one_measured
        if self._pop is not None:
            self._pop.note_t_one(worker_id, t_one_measured)

    def observe_transmit(self, worker_id: str, t_tx_measured: float,
                         n_bytes: int):
        """Record one bandwidth sample: the *delivered copy's* wire time
        for ``n_bytes``.  Contract: callers must pass the one-transmission
        channel time (``bytes / profile.bandwidth``), never ack-to-ack
        wall time — on a lossy link the latter includes retransmit backoff
        waits and would poison every downstream pricing (selection
        budgets, straggler timeouts, RTOs, auto codec choice) by the
        ``1/(1-p)``-with-backoff factor.  The retransmit tax is priced
        separately and explicitly via ``Transport._retx_factor``.  Pinned
        by the chaos-tier regression in tests/test_chaos.py."""
        self._measured_tx[worker_id] = (t_tx_measured, int(n_bytes))
        if self._pop is not None:
            self._pop.note_tx(worker_id, t_tx_measured, int(n_bytes))
