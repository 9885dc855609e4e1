"""Aggregation server (thesis §3.1/§3.3; port of ``repro/core/server.py``):
worker registry, selection, sync/async merge gates, staleness
bookkeeping, accuracy-over-time history.

Synchronous mode (thesis §2.1.2.2): responses based on an older server
version than current are *ignored*; a round aggregates when every
selected worker responded (or the straggler timeout fires).

Asynchronous mode: every arriving response triggers an immediate
aggregation (staleness-weighted, eq 2.4 family) and the responding worker
is immediately re-dispatched.

Responses decode straight to packed flat vectors (or wait encoded, to be
decoded into their rows by the merge, or, in async_delta's delta merge,
decoded and merged by one ``dequant_mix`` launch) and merge in one kernel
pass (``FlatServerState``), followed by the optional server-side
optimizer (``core/server_opt.py``) in packed space.

Cohorts (``cohort=``): each round samples that many alive workers from a
seeded ``random.Random``; only cohort members get links, tickets or
events.  Responses land at arrival in a claimed row of the merge's row
window (a quantised one decoded there by one ``dequant_add``, or in a
delta merge by its ``dequant_mix`` before it lands), the merge
contracts the window, and resident links are LRU-bounded.

Leaf role: under a ``core/topology.Topology`` (``topology_hook``) the
server reports every aggregate and its completion upward, and
``hold``/``release``/``install_global`` gate dispatch around the root's
replacement of its model.

The pending straggler timeout and no-op-round re-dispatch keep their
event handles (``_timeout_ev``, ``_noop_ev``), so a checkpoint can
serialize them and ``resume_round_timeout``/``resume_noop_dispatch``
re-create them.

Sharded substrate (``mesh=``, a 1-D ``parallel.sharding.agg_mesh``): the
packed merge state shards along the parameter axis over the mesh and
every merge runs one kernel launch a device; the transport resolves the
same mesh-aware bundle, and its link vectors are ``Sharded`` over the
same mesh (shard-local, as the JAX package's are).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import tracing

from . import aggregation as agg
from . import flatbuf
from . import server_opt as server_opt_mod
from . import transport as transport_mod
from .estimator import TimeEstimator
from .events import EventLoop
from .population import WorkerPopulation, as_view
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
                 cohort: Optional[int] = None, cohort_seed: int = 0,
                 max_resident_links: Optional[int] = None, server_opt=None,
                 server_opt_kw: Optional[dict] = None):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if aggregator not in agg.UPDATE_WEIGHT_FNS:
            raise ValueError(f"unknown aggregator {aggregator!r}; have "
                             f"{sorted(agg.UPDATE_WEIGHT_FNS)}")
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
        # 1-D aggregation-server mesh: the packed merge substrate shards
        # along N over it
        self.mesh = mesh
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
        # --- massive-scale control plane ---
        # cohort: sample this many alive workers per round; the (W, N) row
        # buffer shrinks to a claimed-row window and resident link state
        # is LRU-bounded by max_resident_links
        self.population = population
        self.cohort = cohort
        self._cohort_rng = (random.Random(cohort_seed)
                            if cohort is not None else None)
        if max_resident_links is None and cohort is not None:
            max_resident_links = max(4 * cohort, 64)
        self.max_resident_links = max_resident_links
        self._profiles_view = None          # cached population view
        self._row_of: Dict[str, int] = {}   # worker -> claimed window row
        self._window = cohort is not None
        self._inflight_w: set = set()       # dispatched, response pending
        # leaf role under a root aggregator (core/topology.py): _finish
        # defers the loop stop to the orchestrator, every aggregate is
        # reported upward, and hold()/release() gate dispatch while a
        # pushed model's global replacement is in flight
        self.topology_hook = None
        self._hold = False
        self._held: List[str] = []          # async workers parked while held
        self._pending_dispatch = False      # sync round deferred while held
        self._started = False               # start() called (mid-run joins)
        self.workers: Dict[str, FLWorker] = {}
        self.warehouse = DataWarehouse()
        self.pointer = Pointer(self.address, self.warehouse.put(weights))
        self._cache: List[agg.WorkerUpdate] = []
        self._outstanding: set = set()
        self._round_open = False
        self._round_id = 0
        # pending-timer handles (checkpoint bookkeeping): the live event of
        # the current round's straggler timeout and of the no-op round's
        # re-dispatch, so a snapshot can serialize and re-create them
        self._timeout_ev = None
        self._timeout_rid = 0
        self._noop_ev = None
        self.history: List[HistoryPoint] = [
            HistoryPoint(0.0, 0, float(eval_fn(weights)), 0, 0)]
        self.done = False

    # --- relationship (thesis §3.3.1) ---
    def add_worker(self, worker: FLWorker):
        joined_mid_run = (self._started and self.mode == "async"
                          and worker.worker_id not in self.workers
                          and not self.done)
        self.workers[worker.worker_id] = worker
        if self.population is not None:
            self.population.adopt(worker.profile)
        self._profiles_view = None
        worker.add_server(self.pointer)
        if joined_mid_run:
            # an async server dispatches per response, so a worker joining
            # it mid-run has nothing to trigger on: kick its first
            # instruction now (sync picks it up at the next selection)
            if self._hold:
                self._held.append(worker.worker_id)
            else:
                self._send_train(worker.worker_id, self.version)

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
        self._started = True
        self._dispatch_round()

    def _accuracy(self) -> float:
        # after the merge's version bump: the round whose merge it scores
        with tracing.span("fl.eval", round=self.version - 1):
            return float(self.eval_fn(self.weights))

    def _finish(self):
        self.done = True
        if self.topology_hook is not None:
            self.topology_hook.on_leaf_done(self)
        else:
            self.loop.stop()

    # --- leaf role under a root aggregator (core/topology.py) ---
    def hold(self):
        """Freeze new dispatches: a leaf push is in flight and the root's
        global replacement has not been installed yet."""
        self._hold = True

    def release(self):
        """Re-open dispatch after :meth:`install_global`: re-run a sync
        round deferred while held, re-dispatch the parked async workers."""
        if not self._hold:
            return
        self._hold = False
        if self.done:
            self._held.clear()
            return
        held, self._held = self._held, []
        for wid in held:
            if wid in self.workers:
                self._send_train(wid, self.version)
        if self._pending_dispatch:
            self._pending_dispatch = False
            self._dispatch_round()

    def install_global(self, weights) -> None:
        """Replace this (leaf) server's model with the root's new global.
        The pointer uid stays (workers' ACLs keep working) and the version
        is not bumped (sync's stale-discard must not fire on an install).
        The packed mirror of the old model, and a server optimizer's
        ``prev`` anchor, are dropped: a merge may have consumed them, and
        neither describes the new model."""
        self.weights = weights
        self._flat.forget_server()
        if self.server_opt is not None:
            self.server_opt.rebase()
        self.warehouse.put(weights, uid=self.pointer.uid)

    def _point(self, acc: float, n_upd: int) -> HistoryPoint:
        return HistoryPoint(self.loop.now, self.version, acc, n_upd, n_upd,
                            self.total_up_bytes, self.total_down_bytes,
                            self.transport.total_retransmits)

    def _dispatch_round(self):
        if self.done:
            return
        if self._hold:
            # held by the topology layer: release() re-enters once the
            # new global is installed
            self._pending_dispatch = True
            return
        if self.version >= self.max_rounds:
            self._finish()
            return
        pool = self.profiles()
        if self.cohort is not None:
            pool = self._sample_cohort(pool)
        selected = self.selector.select(pool)
        self._round_id += 1
        if not selected:
            # nothing admitted (e.g. Alg2 with T=0): burn a no-op round so
            # the policy's on_round_end can open the time budget (eq 3.3)
            acc = self.history[-1].accuracy
            self.selector.on_round_end(acc)
            self.history.append(self._point(acc, 0))
            self.transport.note_round(self.history[-1])
            self.version += 1
            self._noop_ev = self.loop.schedule(1e-3, self._noop_dispatch)
            return
        self._outstanding = set(selected)
        self._round_open = True
        base_version = self.version
        rid = self._round_id
        with tracing.span("fl.dispatch", round=base_version):
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
            self._timeout_rid = rid
            self._timeout_ev = self.loop.schedule(
                self.straggler_timeout_factor * max(t_max, 1e-3),
                self._round_timeout, rid)

    def _sample_cohort(self, pool):
        """Seeded per-round cohort draw: ``cohort`` of the ALIVE workers,
        the pool filtered to the draw in its order.  At ``cohort >=
        alive`` the draw is the whole alive pool, so the run is the run
        without a cohort."""
        view = as_view(pool)
        if view is not None:
            alive = view.ids_where(view.alive_mask())
        else:
            alive = [p.worker_id for p in pool if not p.failed]
        chosen = set(self._cohort_rng.sample(alive,
                                             min(self.cohort, len(alive))))
        if view is not None:
            mask = np.fromiter((wid in chosen for wid in view.worker_ids()),
                               bool, len(view))
            return view.where(mask)
        return [p for p in pool if p.worker_id in chosen]

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
        self._inflight_w.add(wid)
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
        self._inflight_w.discard(res.worker_id)
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
        # + dequantised delta in one fused pass); where the merge is its
        # only reader (no latest-response table), a quantised response
        # stays encoded until the merge decodes all of its rows in one
        # launch, or, in a delta merge, until delta_vec decodes and merges
        # it in one launch.  Under a cohort it lands in its claimed window
        # row now, so outside a delta merge it is decoded now.
        delta = self.async_delta and self.mode == "async"
        if delta or (not self._window and (self.mode == "sync" or not (
                self.async_delta or self.async_latest_table))):
            weights = link.up_vec_deferred(payload)
        else:
            weights = link.decode_up_vec(payload)
        if delta:
            # delta-accumulate in flat-vector space: cur + (new - base);
            # delta codecs already hold the packed base on the link
            # (Sharded on a sharded server, as the pack here is)
            base_vec = (link.tx_base if self.transport.tracks_tx_base
                        else self._flat.pack(
                            self._dispatch_base.get(res.worker_id,
                                                    self.weights)))
            weights = self._flat.delta_vec(self.weights, weights, base_vec)
        if self._window:
            # from here on the update is its claimed row INDEX: _cache and
            # _latest carry the int, and the merge contracts the window.
            # A re-responding worker (latest table) overwrites its row.
            row = self._row_of.get(res.worker_id)
            if row is None:
                row = self._flat.win_claim()
                self._row_of[res.worker_id] = row
            self._flat.win_write(row, weights)
            weights = row
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
                if self._window and not self.async_latest_table:
                    # discarded below-min updates: recycle their rows
                    self._release_rows()
            if not self.done:
                if self._hold:
                    self._held.append(res.worker_id)
                else:
                    self._send_train(res.worker_id, self.version)
        else:
            self._cache.append(agg.WorkerUpdate(weights=weights,
                                                staleness=staleness,
                                                n_data=max(res.n_batches, 1)))
            if not self._outstanding:
                self._aggregate()
                if not self.done:
                    self._dispatch_round()

    def _noop_dispatch(self):
        """The deferred re-dispatch of an empty-selection round (tracked so
        a snapshot can serialize the pending timer)."""
        self._noop_ev = None
        self._dispatch_round()

    def resume_noop_dispatch(self, t_abs: float):
        """Re-create a snapshotted no-op-round re-dispatch timer.  Consumes
        exactly one ``loop.schedule_abs`` call (see
        :meth:`FLWorker.resume_conversation`)."""
        self._noop_ev = self.loop.schedule_abs(t_abs, self._noop_dispatch)

    def resume_round_timeout(self, rid: int, t_abs: float):
        """Re-create a snapshotted straggler-timeout timer (one schedule)."""
        self._timeout_rid = rid
        self._timeout_ev = self.loop.schedule_abs(t_abs,
                                                  self._round_timeout, rid)

    def _round_timeout(self, rid: int):
        if rid == self._timeout_rid:
            self._timeout_ev = None
        if self.done or rid != self._round_id or not self._round_open:
            return
        if self.mode == "sync" and self._outstanding:
            # mark non-responders failed so selection stops picking them,
            # and cancel exactly OUR in-flight transfer from each
            for wid in list(self._outstanding):
                if wid in self.workers:
                    self.workers[wid].profile.failed = True
                    self.workers[wid].cancel_inflight(self.pointer)
                self._inflight_w.discard(wid)
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
        if self._window:
            # cache entries carry claimed row indices: the merge contracts
            # the window with each weight scattered to its row
            with tracing.span("fl.merge", round=self.version):
                self.weights = self._flat.merge_window(
                    self.weights, [u.weights for u in self._cache], ws,
                    alpha)
            if not (self.mode == "async" and self.async_latest_table):
                # merged rows are dead (latest-table workers keep theirs)
                self._release_rows()
        else:
            with tracing.span("fl.merge", round=self.version):
                self.weights = self._flat.merge_rows(
                    self.weights, [u.weights for u in self._cache], ws,
                    alpha)
        # the pointer names the *model*: overwrite in place, uid stays stable
        self.warehouse.put(self.weights, uid=self.pointer.uid)
        n_upd = len(self._cache)
        self._cache = []
        if self.max_resident_links is not None:
            # bound resident link state: evict the coldest quiescent links,
            # never one mid-conversation (in-flight response, claimed
            # window row, parked while held)
            keep = (self._outstanding | self._inflight_w
                    | set(self._row_of) | set(self._held))
            self.transport.lru_evict(keep, self.max_resident_links)
        self.version += 1
        acc = self._accuracy()
        self.selector.on_round_end(acc)
        self.history.append(self._point(acc, n_upd))
        self.transport.note_round(self.history[-1])
        if self.target_accuracy is not None and acc >= self.target_accuracy:
            self._finish()
        elif self.version >= self.max_rounds:
            self._finish()
        if self.topology_hook is not None:
            # leaf-push hook last: the orchestrator sees the appended
            # history point (and, on the final round, the done flag)
            self.topology_hook.on_leaf_aggregate(self)

    def _release_rows(self) -> None:
        for row in self._row_of.values():
            self._flat.win_release(row)
        self._row_of.clear()


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
