"""Aggregation server (thesis §3.1/§3.3; port of ``repro/core/server.py``):
worker registry, selection, sync/async merge gates, staleness
bookkeeping, accuracy-over-time history.

Synchronous mode (thesis §2.1.2.2): responses based on an older server
version than current are *ignored*; a round aggregates when every
selected worker responded (or the straggler timeout fires).

Asynchronous mode: every arriving response triggers an immediate
aggregation (staleness-weighted, eq 2.4 family) and the responding worker
is immediately re-dispatched.

Responses decode straight to packed flat vectors and merge in one kernel
pass (``FlatServerState``), followed by the optional server-side
optimizer (``core/server_opt.py``) in packed space.  Not ported yet: the
sharded substrate (ROADMAP A11), cohorts (A6), the leaf role under a
topology (A9) and checkpoint timers (A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from . import aggregation as agg
from . import flatbuf
from . import server_opt as server_opt_mod
from . import transport as transport_mod
from .estimator import TimeEstimator
from .events import EventLoop
from .population import WorkerPopulation
from .selection import Selector
from .warehouse import DataWarehouse, Pointer
from .worker import FLWorker, TrainResult


@dataclass
class HistoryPoint:
    time: float
    version: int
    accuracy: float
    n_updates: int
    selected: int
    up_bytes: int = 0        # cumulative worker->server wire bytes so far
    down_bytes: int = 0      # cumulative server->worker wire bytes so far
    retransmits: int = 0     # cumulative lossy-link retransmit count so far


class AggregationServer:
    def __init__(self, *, weights, loop: EventLoop, estimator: TimeEstimator,
                 selector: Selector, eval_fn: Callable[[object], float],
                 model_bytes: int, aggregator: str = "fedavg",
                 mode: str = "sync", epochs_per_round: int = 10,
                 max_rounds: int = 100, target_accuracy: Optional[float] = None,
                 straggler_timeout_factor: float = 4.0,
                 async_alpha: float = 1.0, async_stale_pow: float = 0.0,
                 async_min_updates: int = 1, async_delta: bool = False,
                 async_latest_table: bool = True,
                 transport="raw", transport_down: Optional[str] = None,
                 mesh=None, name: str = "aggregator",
                 population: Optional[WorkerPopulation] = None,
                 cohort: Optional[int] = None, server_opt=None,
                 server_opt_kw: Optional[dict] = None):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if aggregator not in agg.UPDATE_WEIGHT_FNS:
            raise ValueError(f"unknown aggregator {aggregator!r}; have "
                             f"{sorted(agg.UPDATE_WEIGHT_FNS)}")
        if cohort is not None:
            raise NotImplementedError("cohort sampling is not ported yet "
                                      "(ROADMAP A6)")
        self.name = name
        self.address = f"server://{name}"
        self.weights = weights
        self.version = 0
        self.loop = loop
        self.est = estimator
        self.selector = selector
        self.eval_fn = eval_fn
        self.model_bytes = model_bytes
        self.aggregator = aggregator
        self.mode = mode
        self.epochs_per_round = epochs_per_round
        self.max_rounds = max_rounds
        self.target_accuracy = target_accuracy
        self.straggler_timeout_factor = straggler_timeout_factor
        self.async_alpha = async_alpha
        self.async_stale_pow = async_stale_pow
        # the thesis' `synchronous_federate_minimum_client` knob applied to
        # async: merge once >= this many responses are cached
        self.async_min_updates = async_min_updates
        # beyond-paper: merge worker *deltas* (w_new - w_base) into the
        # current server weights (FedBuff-style)
        self.async_delta = async_delta
        # eq 2.2/2.4 faithful mode: aggregate over each worker's *latest*
        # response; False = FedAsync-style single-arrival alpha-nudging
        self.async_latest_table = async_latest_table
        self._dispatch_base: Dict[str, object] = {}
        self._latest: Dict[str, tuple] = {}   # async: worker -> latest response
        self._flat = flatbuf.flat_state_for(weights, mesh=mesh)
        if self._flat is None:
            raise ValueError("weights must be a non-empty dict of tensors")
        # optional server-side optimizer: with None the merge tail is the
        # plain FedAvg install
        self.server_opt = server_opt_mod.make_server_opt(
            server_opt, **(server_opt_kw or {}))
        self._flat.server_opt = self.server_opt
        if isinstance(transport, str):
            transport = transport_mod.Transport(weights, codec=transport,
                                                down_codec=transport_down,
                                                raw_bytes=model_bytes,
                                                mesh=mesh)
        self.transport = transport
        if not agg.use_flat_vec(self._flat, transport, aggregator):
            raise ValueError("the transport must share the server's "
                             "flat-buffer bundle")
        self.total_up_bytes = 0
        self.total_down_bytes = 0
        self.population = population
        self._profiles_view = None          # cached population view
        self.workers: Dict[str, FLWorker] = {}
        self.warehouse = DataWarehouse()
        self.pointer = Pointer(self.address, self.warehouse.put(weights))
        self._cache: List[agg.WorkerUpdate] = []
        self._outstanding: set = set()
        self._round_open = False
        self._round_id = 0
        self.history: List[HistoryPoint] = [
            HistoryPoint(0.0, 0, float(eval_fn(weights)), 0, 0)]
        self.done = False

    # --- relationship (thesis §3.3.1) ---
    def add_worker(self, worker: FLWorker):
        self.workers[worker.worker_id] = worker
        if self.population is not None:
            self.population.adopt(worker.profile)
        self._profiles_view = None
        worker.add_server(self.pointer)

    def remove_worker(self, worker_id: str):
        w = self.workers.pop(worker_id, None)
        if self.population is not None:
            self.population.release(worker_id)
        self._profiles_view = None
        if w is not None:
            # a departed worker's late response could never be redeemed:
            # cancel its in-flight transfers and revoke its ACL entry
            w.cancel_inflight(self.pointer)
            w.remove_server(self.pointer)

    def profiles(self):
        """Registered workers' profiles, in registry order (a
        ``PopulationView`` when a population is bound)."""
        if self.population is not None:
            if self._profiles_view is None:
                self._profiles_view = self.population.view_for(self.workers)
            return self._profiles_view
        return [w.profile for w in self.workers.values()]

    # --- main loop ---
    def start(self):
        self._dispatch_round()

    def _accuracy(self) -> float:
        return float(self.eval_fn(self.weights))

    def _finish(self):
        self.done = True
        self.loop.stop()

    def _point(self, acc: float, n_upd: int) -> HistoryPoint:
        return HistoryPoint(self.loop.now, self.version, acc, n_upd, n_upd,
                            self.total_up_bytes, self.total_down_bytes,
                            self.transport.total_retransmits)

    def _dispatch_round(self):
        if self.done:
            return
        if self.version >= self.max_rounds:
            self._finish()
            return
        selected = self.selector.select(self.profiles())
        self._round_id += 1
        if not selected:
            # nothing admitted (e.g. Alg2 with T=0): burn a no-op round so
            # the policy's on_round_end can open the time budget (eq 3.3)
            acc = self.history[-1].accuracy
            self.selector.on_round_end(acc)
            self.history.append(self._point(acc, 0))
            self.transport.note_round(self.history[-1])
            self.version += 1
            self.loop.schedule(1e-3, self._dispatch_round)
            return
        self._outstanding = set(selected)
        self._round_open = True
        base_version = self.version
        rid = self._round_id
        down_b = {wid: self._send_train(wid, base_version)
                  for wid in selected}
        if self.mode == "sync":
            # straggler timeout: aggregate with whatever arrived; priced on
            # the actual encoded dispatch down plus the codec'd response up
            up_b = self.transport.expected_up_bytes()
            t_max = max(self.est.t_one(self.workers[w].profile) *
                        self.epochs_per_round +
                        self.est.t_transmit(self.workers[w].profile,
                                            down_b[w]) +
                        self.est.t_transmit(self.workers[w].profile, up_b)
                        for w in selected)
            self.loop.schedule(
                self.straggler_timeout_factor * max(t_max, 1e-3),
                self._round_timeout, rid)

    def _send_train(self, wid: str, base_version: int) -> int:
        """Dispatch one train instruction; returns the actual downlink
        payload bytes."""
        w = self.workers.get(wid)
        if w is None:
            return 0
        link = self.transport.link(wid)
        down = link.encode_down(self.weights)
        self.total_down_bytes += down.wire_bytes
        if self.async_delta:
            self._dispatch_base[wid] = self.weights
        w.train_async(self.pointer, down, base_version,
                      self.epochs_per_round, link, self._on_response)
        return down.wire_bytes

    # --- response handling (thesis §3.3.3 steps 8-9) ---
    def _on_response(self, res: TrainResult):
        w = self.workers.get(res.worker_id)
        if w is None:
            return
        # redeem FIRST: redemption deletes the stored payload
        payload = w.warehouse.redeem_ticket(res.weights_ticket)
        if self.done:
            return
        self.total_up_bytes += res.up_bytes   # the bytes crossed the wire
        self.est.observe_training(res.worker_id,
                                  res.t_train / max(res.epochs, 1))
        self.est.observe_transmit(res.worker_id, res.t_up, res.up_bytes)
        staleness = self.version - res.base_version
        if self.population is not None:
            self.population.note_response(res.worker_id, res.base_version,
                                          staleness)
        link = self.transport.link(res.worker_id)
        if self.mode == "sync" and staleness > 0:
            # sync ignores results that straddle an aggregation; the
            # encoded mass goes back into the link's EF residual
            link.restore_uplink(payload)
            return
        # decode straight to a packed flat vector (compressed codecs: base
        # + dequantised delta in one fused pass)
        weights = link.decode_up_vec(payload)
        if self.async_delta and self.mode == "async":
            # delta-accumulate in flat-vector space: cur + (new - base);
            # delta codecs already hold the packed base on the link
            base_vec = (link.tx_base if self.transport.tracks_tx_base
                        else self._flat.bundle.pack(
                            self._dispatch_base.get(res.worker_id,
                                                    self.weights)))
            weights = self._flat.delta_vec(self.weights, weights, base_vec)
        self._outstanding.discard(res.worker_id)
        if self.mode == "async":
            if self.async_latest_table:
                # eq 2.2/2.4: average *each worker's latest response*,
                # staleness-weighted at merge time
                self._latest[res.worker_id] = (weights, res.base_version,
                                               max(res.n_batches, 1))
                self._cache = [
                    agg.WorkerUpdate(weights=wt,
                                     staleness=self.version - bv,
                                     n_data=nd)
                    for (wt, bv, nd) in self._latest.values()]
            else:
                self._cache.append(agg.WorkerUpdate(
                    weights=weights, staleness=staleness,
                    n_data=max(res.n_batches, 1)))
            if len(self._cache) >= self.async_min_updates:
                self._aggregate()
            else:
                self._cache = []
            if not self.done:
                self._send_train(res.worker_id, self.version)
        else:
            self._cache.append(agg.WorkerUpdate(weights=weights,
                                                staleness=staleness,
                                                n_data=max(res.n_batches, 1)))
            if not self._outstanding:
                self._aggregate()
                if not self.done:
                    self._dispatch_round()

    def _round_timeout(self, rid: int):
        if self.done or rid != self._round_id or not self._round_open:
            return
        if self.mode == "sync" and self._outstanding:
            # mark non-responders failed so selection stops picking them,
            # and cancel exactly OUR in-flight transfer from each
            for wid in list(self._outstanding):
                if wid in self.workers:
                    self.workers[wid].profile.failed = True
                    self.workers[wid].cancel_inflight(self.pointer)
            self._outstanding.clear()
            if self._cache:
                self._aggregate()
            if not self.done:
                self._dispatch_round()

    def _aggregate(self):
        if not self._cache:
            return
        self._round_open = False
        # async merges are damped (FedAsync-style server mixing), scaled
        # down further for stale responses (eq 2.4 family)
        if self.mode == "async" and not self.async_latest_table:
            stale = max(u.staleness for u in self._cache)
            alpha = self.async_alpha * (1.0 + stale) ** (-self.async_stale_pow)
        else:
            alpha = 1.0
        ws = agg.update_weights(self.aggregator, self._cache)
        # the staleness-weighted sum + alpha-mix in one kernel pass
        self.weights = self._flat.merge_rows(
            self.weights, [u.weights for u in self._cache], ws, alpha)
        # the pointer names the *model*: overwrite in place, uid stays stable
        self.warehouse.put(self.weights, uid=self.pointer.uid)
        n_upd = len(self._cache)
        self._cache = []
        self.version += 1
        acc = self._accuracy()
        self.selector.on_round_end(acc)
        self.history.append(self._point(acc, n_upd))
        self.transport.note_round(self.history[-1])
        if self.target_accuracy is not None and acc >= self.target_accuracy:
            self._finish()
        elif self.version >= self.max_rounds:
            self._finish()


def run_sequential(*, weights, train_fn, eval_fn, data, per_batch_time: float,
                   n_batches: int, epochs_per_round: int = 10,
                   max_rounds: int = 100,
                   target_accuracy: Optional[float] = None) -> List[HistoryPoint]:
    """The thesis' sequential baseline: all data in one place, trained
    single-threaded; simulated time = per-batch time x batches x epochs."""
    history = [HistoryPoint(0.0, 0, float(eval_fn(weights)), 0, 0)]
    t = 0.0
    for r in range(max_rounds):
        weights = train_fn(weights, data["x"], data["y"], epochs_per_round)
        t += per_batch_time * n_batches * epochs_per_round
        acc = float(eval_fn(weights))
        history.append(HistoryPoint(t, r + 1, acc, 1, 1))
        if target_accuracy is not None and acc >= target_accuracy:
            break
    return history
