"""Hierarchical multi-server federation (port of ``repro/core/topology.py``).

Several leaf :class:`~repro_torch.core.server.AggregationServer`\\ s each
drive a disjoint worker pool and periodically push their merged models up
a server<->server link to a ROOT aggregator, which re-merges the leaf
contributions with the same fused flat-buffer pass
(``FlatServerState.merge_rows``: B2, or B1 when the root mixes) and fans
the new global back down.

Wire discipline.  Server<->server links are ordinary transport
:class:`~repro_torch.core.transport.Link`\\ s of the root's own
:class:`~repro_torch.core.transport.Transport`: a leaf push is the uplink
(a codec'd delta against the global the leaf last installed), a root
fan-out the downlink (a delta against the leaf's last-acked global, raw at
first contact).  The root's history counts exactly the server-link
payload bytes (uplink at arrival, downlink at dispatch).

Push modes.  ``push="sync"`` barriers: the root merges once every alive
leaf's push has arrived, then fans the new global to all of them.
``push="async"`` merges each arriving push at once (staleness-damped) and
fans back to the pusher alone.  A leaf holds its dispatch between its push
and the fan-out's arrival.

``"1x1"`` runs in passthrough: the root is colocated with its only leaf,
there is no server<->server wire, and the root's history is the leaf's
verbatim, the single-server run bit for bit.

Worker ack state is shared topology-wide (one ``WorkerAckRegistry``), and
so is the root's per-leaf ack state: on :meth:`Topology.kill_root` the
most senior surviving leaf is promoted in place, every survivor re-parents
to the promoted root's fresh transport, and the first dispatch to each is
a delta against the global it holds.

Each in-flight push and fan-out keeps a record (``push_rec``,
``fan_rec``) of the inputs its delivery consumes, so a checkpoint can
serialize the leg and ``resume_push``/``resume_fan``/
``resume_done_settled`` re-create it; ``run_fl_topology`` takes the
checkpoint arguments of ``run_fl``.

``server_mesh`` shards the root's and every leaf's merge substrate over
one 1-D ``agg`` mesh, as in ``run_fl``; a failed-over root rebuilds its
transport over the same mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Dict, List, Optional, Sequence

from . import aggregation as agg
from . import flatbuf
from . import population as population_mod
from . import server_opt as server_opt_mod
from . import transport as transport_mod
from .estimator import TimeEstimator
from .events import EventLoop
from .experiment import bind_nominal_bandwidth, resolve_mesh
from .selection import make_pool_selectors
from .server import AggregationServer, HistoryPoint
from .worker import FLWorker


@dataclass
class TopologyConfig:
    """One hierarchical run's shape + server<->server wire parameters."""
    n_leaves: int = 1
    push: str = "sync"            # root merge gate: "sync" barrier | "async"
    push_every: int = 1           # leaf aggregations per upward push
    server_codec: str = "delta"   # leaf->root codec (flat-buffer delta path)
    server_codec_down: Optional[str] = None   # root->leaf (None = symmetric)
    server_frac: float = 0.1
    server_bandwidth: float = 1e9  # bytes/s per server<->server link
    root_aggregator: str = "linear"  # across-leaf weights (staleness, n_data)
    root_alpha: Optional[float] = None  # None: 1.0 sync-push, 0.5 async-push
    root_stale_pow: float = 0.5   # async-push staleness damping exponent
    root_rounds: Optional[int] = None   # cap on global versions
    pools: Optional[Sequence[Sequence[int]]] = None  # worker idx per leaf
    passthrough: bool = False     # 1x1 identity: root colocated, no wire
    root_failover: bool = True    # root death promotes the senior leaf
                                  # (False: root death ends the run)

    def __post_init__(self):
        if self.push not in ("sync", "async"):
            raise ValueError(f"push mode {self.push!r}")
        if self.n_leaves < 1:
            raise ValueError("need at least one leaf")
        if self.push_every < 1:
            raise ValueError("push_every must be >= 1")
        if self.passthrough and self.n_leaves != 1:
            raise ValueError("passthrough is the 1-leaf identity topology")
        if self.root_aggregator not in agg.UPDATE_WEIGHT_FNS:
            raise ValueError(f"unknown root aggregator "
                             f"{self.root_aggregator!r}; "
                             f"have {sorted(agg.UPDATE_WEIGHT_FNS)}")


def parse_topology(spec, **overrides) -> TopologyConfig:
    """``"1x1"`` / ``"1x4"`` (root x leaves), a leaf count, or a
    :class:`TopologyConfig`.  The 1-leaf string/int spelling is the
    passthrough identity; ``overrides`` replace config fields."""
    if isinstance(spec, TopologyConfig):
        cfg = spec
    else:
        if isinstance(spec, str):
            parts = spec.lower().split("x")
            if len(parts) == 2:
                if int(parts[0]) != 1:
                    raise ValueError(f"only 1-root topologies: {spec!r}")
                n = int(parts[1])
            elif len(parts) == 1:
                n = int(parts[0])
            else:
                raise ValueError(f"topology spec {spec!r}")
        elif isinstance(spec, int):
            n = spec
        else:
            raise TypeError(f"topology spec {spec!r}")
        cfg = TopologyConfig(n_leaves=n, passthrough=(n == 1))
    if overrides:
        cfg = dc_replace(cfg, **overrides)
    return cfg


class _Leaf:
    """Root-side bookkeeping for one leaf server."""

    __slots__ = ("lid", "server", "link", "bandwidth", "dead", "started",
                 "agg_since_push", "n_data_since_push", "push_inflight",
                 "fan_inflight", "push_rec", "fan_rec", "done_settling",
                 "base_root_version", "merged_base")

    def __init__(self, lid: str, server: AggregationServer, link,
                 bandwidth: float):
        self.lid = lid
        self.server = server
        self.link = link              # root-side server<->server Link
        self.bandwidth = bandwidth
        self.dead = False
        self.started = False
        self.agg_since_push = 0       # leaf aggregates since last push
        self.n_data_since_push = 0    # worker updates folded in since then
        self.push_inflight = None     # leaf->root Payload in flight
        self.fan_inflight = None      # root->leaf Payload in flight
        self.push_rec = None          # checkpoint record of the push leg
        self.fan_rec = None           # checkpoint record of the fan leg
        self.done_settling = None     # pending _leaf_done_settled event
        self.base_root_version = 0    # root version the leaf last installed
        # the leaf model of this leaf's most recently MERGED push: what the
        # current global already contains.  A fan-out pins it at dispatch
        # and the install re-bases on it
        self.merged_base = None


class Topology:
    """Root aggregator + orchestrator for one hierarchical run: the global
    model, the server<->server transport (one codec'd link per leaf), the
    fused re-merge and the root's :class:`HistoryPoint` sequence.  It is
    also every leaf server's ``topology_hook``."""

    # effectively infinite: the promoted root is colocated with its leaf,
    # so their transfers cross process memory, not a wire
    _LOOPBACK_BW = 1e18

    def __init__(self, *, weights, loop: EventLoop, eval_fn,
                 model_bytes: int, config: TopologyConfig, mesh=None,
                 target_accuracy: Optional[float] = None,
                 server_opt=None):
        self.cfg = config
        # 1-D aggregation-server mesh of the root's merge substrate (and of
        # its transport, rebuilt over it on failover)
        self.mesh = mesh
        self.loop = loop
        self.eval_fn = eval_fn
        self.weights = weights
        self.version = 0
        self.model_bytes = model_bytes
        self.target_accuracy = target_accuracy
        self.total_up_bytes = 0
        self.total_down_bytes = 0
        self.leaves: Dict[str, _Leaf] = {}
        self.done = False
        self.failovers = 0
        # (leaf_id, payload codec, had-acked-base) per first post-failover
        # dispatch: the chaos auditor's delta-not-raw-resume evidence
        self.failover_dispatches: List[tuple] = []
        # leaf_id -> (decoded contribution, base root version, n_data,
        # leaf snapshot): pushes that arrived but have not merged yet
        self._pending: Dict[str, tuple] = {}
        self._alpha = (config.root_alpha if config.root_alpha is not None
                       else (0.5 if config.push == "async" else 1.0))
        # the root carries the server optimizer; passthrough has no root
        # merge, and build_topology hands it to the lone leaf instead
        self.server_opt = server_opt if not config.passthrough else None
        if config.passthrough:
            self.transport = None
            self._server_acks = None
            self._flat = None
        else:
            # the per-leaf downlink ack state lives in a topology-owned
            # registry: it must survive the root transport's rebuild on
            # failover
            self._server_acks = transport_mod.WorkerAckRegistry()
            self.transport = self._new_transport(weights)
            self._flat = flatbuf.flat_state_for(weights, mesh=mesh)
            if self._flat is None:
                raise ValueError("weights must be a non-empty dict of "
                                 "tensors")
            self._flat.server_opt = self.server_opt
        # passthrough: finalize() copies the leaf's history
        self.history: List[HistoryPoint] = [] if config.passthrough else [
            HistoryPoint(0.0, 0, float(eval_fn(weights)), 0, 0)]

    # --- wiring ---
    def _new_transport(self, weights) -> transport_mod.Transport:
        cfg = self.cfg
        tr = transport_mod.Transport(
            weights, codec=cfg.server_codec, down_codec=cfg.server_codec_down,
            frac=cfg.server_frac, raw_bytes=self.model_bytes,
            mesh=self.mesh, ack_registry=self._server_acks)
        if tr.tuner is not None:
            # an auto backbone prices the configured per-leaf link rates
            def _leaf_bw(lid):
                lf = self.leaves.get(lid)
                return None if lf is None else lf.bandwidth

            def _rep_bw():
                if not self.leaves:
                    return None
                rates = sorted(lf.bandwidth for lf in self.leaves.values())
                return rates[len(rates) // 2]

            tr.tuner.bind_bandwidth(_leaf_bw, _rep_bw)
        return tr

    def attach_leaf(self, server: AggregationServer,
                    bandwidth: Optional[float] = None) -> _Leaf:
        lid = server.name
        if lid in self.leaves:
            raise ValueError(f"duplicate leaf {lid!r}")
        link = None if self.cfg.passthrough else self.transport.link(lid)
        lf = _Leaf(lid, server, link,
                   bandwidth if bandwidth is not None
                   else self.cfg.server_bandwidth)
        server.topology_hook = self
        self.leaves[lid] = lf
        return lf

    def start(self):
        if self.cfg.passthrough:
            for lf in self.leaves.values():
                lf.started = True
                lf.server.start()
            return
        # first contact: the root provisions every leaf with the initial
        # global (a raw dispatch that also establishes each link's bases)
        for lf in self.leaves.values():
            self._fan_out(lf)

    def finalize(self):
        """Post-run bookkeeping: in passthrough the root IS the leaf, so
        the root history becomes the leaf's verbatim."""
        if self.cfg.passthrough:
            (lf,) = self.leaves.values()
            self.history = [HistoryPoint(p.time, p.version, p.accuracy,
                                         p.n_updates, p.selected,
                                         p.up_bytes, p.down_bytes,
                                         p.retransmits)
                            for p in lf.server.history]
            self.weights = lf.server.weights
            self.version = lf.server.version

    # --- leaf hooks (AggregationServer.topology_hook protocol) ---
    def on_leaf_aggregate(self, server: AggregationServer):
        if self.cfg.passthrough:
            return
        lf = self.leaves[server.name]
        if lf.dead:
            return
        h = server.history[-1]
        lf.agg_since_push += 1
        lf.n_data_since_push += h.n_updates
        if (lf.agg_since_push >= self.cfg.push_every
                and lf.push_inflight is None):
            self._start_push(lf)

    def on_leaf_done(self, server: AggregationServer):
        if self.cfg.passthrough:
            self.loop.stop()
            return
        lf = self.leaves.get(server.name)
        if lf is None or lf.dead:
            return
        # settle after the current call stack: the final aggregate's
        # on_leaf_aggregate (which may start the final push) runs first
        lf.done_settling = self.loop.call_soon(self._leaf_done_settled, lf)

    def _leaf_done_settled(self, lf: _Leaf):
        lf.done_settling = None
        if self.done or lf.dead:
            return
        if (lf.agg_since_push > 0 and lf.push_inflight is None
                and lf.started):
            self._start_push(lf)       # flush a partial push_every window
        if self.cfg.push == "sync":
            self._maybe_sync_merge()   # barrier no longer waits on this leaf
        self._check_done()

    # --- upward leg: leaf -> root push ---
    def _start_push(self, lf: _Leaf):
        server = lf.server
        server.hold()
        snap = server.weights             # what this push tells the root
        payload = lf.link.encode_up(snap)
        base_rv = lf.base_root_version
        n_data = max(lf.n_data_since_push, 1)
        lf.agg_since_push = 0
        lf.n_data_since_push = 0
        lf.push_inflight = payload
        rec = {"payload": payload, "base_rv": base_rv, "n_data": n_data,
               "snap": snap, "ev": None}
        lf.push_rec = rec
        rec["ev"] = transport_mod.transmit(
            self.loop, lf.link, payload,
            payload.wire_bytes / max(lf.bandwidth, 1.0),
            lambda: self._push_arrive(lf, payload, base_rv, n_data, snap),
            direction="up")

    def resume_push(self, lf: _Leaf, rec: dict, t_abs: float):
        """Re-create a snapshotted in-flight push leg (one schedule)."""
        payload = rec["payload"]
        lf.push_inflight = payload
        lf.push_rec = rec
        base_rv, n_data, snap = rec["base_rv"], rec["n_data"], rec["snap"]
        rec["ev"] = transport_mod.resume_transmit(
            self.loop, lf.link, payload, t_abs,
            lambda: self._push_arrive(lf, payload, base_rv, n_data, snap),
            direction="up")

    def _push_arrive(self, lf: _Leaf, payload, base_rv: int, n_data: int,
                     snap):
        if lf.push_inflight is not payload:
            return        # cancelled (leaf died mid-push); EF already reverted
        lf.push_inflight = None
        lf.push_rec = None
        if self.done:
            lf.link.restore_uplink(payload)
            return
        self.total_up_bytes += payload.wire_bytes   # bytes crossed the wire
        contrib = lf.link.decode_up_vec(payload)
        prev = self._pending.get(lf.lid)
        if prev is not None:
            # a second push landed before the barrier merged the first:
            # the newer snapshot embodies both windows' worker updates, so
            # the n_data merge weight accumulates
            n_data += prev[2]
        self._pending[lf.lid] = (contrib, base_rv, n_data, snap)
        if lf.server.done and lf.agg_since_push > 0 and not lf.dead:
            # the leaf finished while this push was in flight, with more
            # aggregates banked since: flush them now (done leaves get no
            # fan-out, so nothing else re-triggers a push)
            self._start_push(lf)
        if self.cfg.push == "async":
            self._merge()
        else:
            self._maybe_sync_merge()
        self._check_done()

    def _maybe_sync_merge(self):
        if not self._pending:
            return
        # the barrier waits on every leaf that can still contribute this
        # cycle: alive and either not finished, mid-push, or pending
        expected = {lid for lid, lf in self.leaves.items()
                    if not lf.dead and (not lf.server.done
                                        or lf.push_inflight is not None
                                        or lid in self._pending)}
        if expected.issubset(self._pending.keys()):
            self._merge()

    # --- root merge + downward leg ---
    def _merge(self):
        order = sorted(self._pending)
        entries = [self._pending[lid] for lid in order]
        self._pending.clear()
        for lid, (_, _, _, snap) in zip(order, entries):
            if lid in self.leaves:
                # this global now contains the leaf's snapshot
                self.leaves[lid].merged_base = snap
        ups = [agg.WorkerUpdate(weights=c, staleness=self.version - bv,
                                n_data=nd) for c, bv, nd, _ in entries]
        ws = agg.update_weights(self.cfg.root_aggregator, ups)
        alpha = self._alpha
        if self.cfg.push == "async":
            stale = max(u.staleness for u in ups)
            alpha = self._alpha * (1.0 + stale) ** (-self.cfg.root_stale_pow)
        self.weights = self._flat.merge_rows(
            self.weights, [u.weights for u in ups], ws, alpha)
        self.version += 1
        acc = float(self.eval_fn(self.weights))
        alive = sum(1 for lf in self.leaves.values() if not lf.dead)
        self.history.append(HistoryPoint(self.loop.now, self.version, acc,
                                         len(ups), alive,
                                         self.total_up_bytes,
                                         self.total_down_bytes,
                                         self.transport.total_retransmits))
        self.transport.note_round(self.history[-1])
        if ((self.target_accuracy is not None
             and acc >= self.target_accuracy)
                or (self.cfg.root_rounds is not None
                    and self.version >= self.cfg.root_rounds)):
            self._finish_all()
            return
        if self.cfg.push == "async":
            targets = [self.leaves[lid] for lid in order
                       if lid in self.leaves]
        else:
            targets = list(self.leaves.values())
        for lf in targets:
            if not lf.dead and not lf.server.done and lf.fan_inflight is None:
                self._fan_out(lf)

    def _fan_out(self, lf: _Leaf):
        payload = lf.link.encode_down(self.weights)
        self.total_down_bytes += payload.wire_bytes   # counted at dispatch
        lf.fan_inflight = payload
        # pin the rebase snapshot at dispatch: THIS global contains only
        # the snapshot merged so far
        v_enc, base = self.version, lf.merged_base
        rec = {"payload": payload, "v_enc": v_enc, "base": base, "ev": None}
        lf.fan_rec = rec
        rec["ev"] = transport_mod.transmit(
            self.loop, lf.link, payload,
            payload.wire_bytes / max(lf.bandwidth, 1.0),
            lambda: self._fan_arrive(lf, payload, v_enc, base),
            direction="down")

    def resume_fan(self, lf: _Leaf, rec: dict, t_abs: float):
        """Re-create a snapshotted in-flight fan-out leg (one schedule)."""
        payload = rec["payload"]
        lf.fan_inflight = payload
        lf.fan_rec = rec
        v_enc, base = rec["v_enc"], rec["base"]
        rec["ev"] = transport_mod.resume_transmit(
            self.loop, lf.link, payload, t_abs,
            lambda: self._fan_arrive(lf, payload, v_enc, base),
            direction="down")

    def resume_done_settled(self, lf: _Leaf, t_abs: float):
        """Re-create a snapshotted pending leaf-done settle (one schedule)."""
        lf.done_settling = self.loop.schedule_abs(
            t_abs, self._leaf_done_settled, lf)

    def _fan_arrive(self, lf: _Leaf, payload, v_enc: int, base=None):
        if lf.fan_inflight is not payload:
            return        # cancelled (leaf died mid-fetch); ack untouched
        lf.fan_inflight = None
        lf.fan_rec = None
        if lf.dead or lf.server.done:
            # never delivered: the ack must not advance, the downlink EF
            # revert chain unlinks this encode
            lf.link.restore_downlink(payload)
            self._check_done()
            return
        if self.transport.audit is not None:
            # chaos ledger: this leaf now holds the version-v_enc global
            self.transport.audit.note_fetch(lf.lid, v_enc)
        tree = lf.link.complete_fetch(payload)
        server = lf.server
        if base is not None and server.weights is not base:
            # an async leaf keeps merging while held, so its model may be
            # ahead of the snapshot this global merged: install global +
            # (leaf_now - merged_snapshot), the fused delta-accumulate
            tree = server._flat.apply_delta(tree, server.weights, base)
        server.install_global(tree)
        lf.base_root_version = v_enc
        if not lf.started:
            lf.started = True
            lf.server.start()
        else:
            lf.server.release()
        self._check_done()

    # --- faults / termination ---
    def kill_leaf(self, leaf_id: str):
        """A leaf server dies: its pool goes silent, a push mid-flight
        never reaches the root and its encoded mass returns to the link's
        uplink EF residual, a fan-out mid-flight never advances the ack.
        Its workers stay alive for re-attachment (``ElasticPool``)."""
        lf = self.leaves[leaf_id]
        if lf.dead:
            return
        lf.dead = True
        lf.server.done = True
        if lf.push_inflight is not None:
            lf.link.restore_uplink(lf.push_inflight)
            lf.push_inflight = None
            lf.push_rec = None
        if lf.fan_inflight is not None:
            lf.link.restore_downlink(lf.fan_inflight)
            lf.fan_inflight = None
            lf.fan_rec = None
        if self.cfg.push == "sync":
            self._maybe_sync_merge()
        self._check_done()

    def kill_leaf_at(self, t: float, leaf_id: str):
        self.loop.at(t, self.kill_leaf, leaf_id)

    def kill_root(self):
        """The ROOT aggregator dies.  In-flight server<->server transfers
        roll back as in :meth:`kill_leaf`; pushes that arrived but had not
        merged die with the root's memory (each leaf's next push re-ships
        its state against its still-held ``tx_base``).  With
        ``root_failover`` the senior surviving leaf is promoted in place
        (:meth:`_promote_root`); without it the run ends."""
        if self.cfg.passthrough:
            raise ValueError("passthrough topology has no separate root")
        if self.done:
            return
        # the dead process's retransmit timers die with it
        self.transport.closed = True
        for lf in self.leaves.values():
            if lf.push_inflight is not None:
                lf.link.restore_uplink(lf.push_inflight)
                lf.push_inflight = None
                lf.push_rec = None
            if lf.fan_inflight is not None:
                lf.link.restore_downlink(lf.fan_inflight)
                lf.fan_inflight = None
                lf.fan_rec = None
        self._pending.clear()
        if not self.cfg.root_failover:
            self._finish_all()
            return
        survivors = [lf for lf in self.leaves.values() if not lf.dead]
        if not survivors:
            self._check_done()
            return
        self._promote_root(survivors[0])

    def _promote_root(self, promoted: _Leaf):
        """Seniority election (attach order) + re-parenting.  The promoted
        leaf's model becomes the global; the root transport is rebuilt
        around it, but the per-leaf ack registry survives, so the first
        post-failover dispatch to each survivor is a delta.  Version,
        history and counters carry over: the root is a role."""
        self.failovers += 1
        old = self.transport
        self.weights = promoted.server.weights
        # the root's packed mirror and the optimizer's prev anchor describe
        # the dead root's model; momentum / second moments ride along
        self._flat.forget_server()
        if self.server_opt is not None:
            self.server_opt.rebase()
        tr = self._new_transport(self.weights)
        # same physical links, same lossy channel, one continuous ledger
        tr.reliability = old.reliability
        tr.rel_estimator = old.rel_estimator
        tr.total_retransmits = old.total_retransmits
        tr.audit = old.audit
        if tr.tuner is not None and old.tuner is not None:
            tr.tuner.carry_schedule(old.tuner)
        self.transport = tr
        for lf in self.leaves.values():
            if lf.dead:
                continue
            lf.link = tr.link(lf.lid)
            # the dead root's memory of unmerged in-window progress is
            # gone; the first post-failover install is an exact replace
            lf.merged_base = None
            if lf is promoted:
                lf.bandwidth = self._LOOPBACK_BW
                lf.link.reliability = None    # loopbacks don't drop
        # re-provision every survivor at once
        for lf in self.leaves.values():
            if not lf.dead and not lf.server.done:
                had_base = lf.link.acked_base is not None
                self._fan_out(lf)
                self.failover_dispatches.append(
                    (lf.lid, lf.fan_inflight.codec, had_base))
        self._check_done()

    def kill_root_at(self, t: float):
        self.loop.at(t, self.kill_root)

    def _finish_all(self):
        self.done = True
        for lf in self.leaves.values():
            lf.server.done = True
        self.loop.stop()

    def _check_done(self):
        if self.done:
            return
        if (all(lf.dead or lf.server.done for lf in self.leaves.values())
                and not self._pending
                and not any(lf.push_inflight is not None
                            or lf.fan_inflight is not None
                            for lf in self.leaves.values())):
            self.done = True
            self.loop.stop()


@dataclass
class TopologyResult:
    """One hierarchical run: the root's global history, per-leaf local
    histories, and the orchestrator itself."""
    root_history: List[HistoryPoint]
    leaf_histories: Dict[str, List[HistoryPoint]]
    topology: Topology
    config: TopologyConfig


def _partition_pools(n_workers: int, cfg: TopologyConfig) -> List[List[int]]:
    if cfg.pools is not None:
        pools = [list(p) for p in cfg.pools]
        if len(pools) != cfg.n_leaves:
            raise ValueError("one pool per leaf")
        seen = [i for p in pools for i in p]
        if sorted(seen) != list(range(n_workers)):
            raise ValueError("pools must partition the worker set")
        return pools
    return [[i for i in range(n_workers) if i % cfg.n_leaves == j]
            for j in range(cfg.n_leaves)]


def build_topology(setup, *, topology, mode: str = "sync",
                   selector: str = "all", aggregator: str = "fedavg",
                   epochs_per_round: int = 10, max_rounds: int = 60,
                   target_accuracy: Optional[float] = None,
                   selector_kw: Optional[dict] = None,
                   server_freq: float = 3.0, async_alpha: float = 1.0,
                   async_stale_pow: float = 0.0, async_min_updates: int = 1,
                   async_delta: bool = False, async_latest_table: bool = True,
                   transport: str = "raw",
                   transport_down: Optional[str] = None,
                   transport_frac: float = 0.1,
                   server_mesh: Optional[int] = None,
                   cohort: Optional[int] = None, cohort_seed: int = 0,
                   server_opt=None, server_opt_kw: Optional[dict] = None):
    """Construct (but do not run) one hierarchical system: the shared
    event loop, the root :class:`Topology`, and one leaf
    :class:`AggregationServer` per pool with its own estimator, selector,
    transport (sharing one topology-wide ``WorkerAckRegistry``) and
    workers, on the setup's device.  ``max_rounds`` counts each leaf's
    LOCAL rounds; ``target_accuracy`` is checked on the root's global
    model (on the leaf in passthrough)."""
    cfg = parse_topology(topology)
    mesh = resolve_mesh(server_mesh, setup.device)
    loop = EventLoop()
    # leaf merges stay plain FedAvg and the ROOT carries the optimizer; in
    # passthrough the lone leaf gets it, keeping 1x1 == single server
    opt = server_opt_mod.make_server_opt(server_opt, **(server_opt_kw or {}))
    topo = Topology(weights=setup.weights0, loop=loop, eval_fn=setup.eval_fn,
                    model_bytes=setup.model_bytes, config=cfg, mesh=mesh,
                    target_accuracy=None if cfg.passthrough
                    else target_accuracy,
                    server_opt=None if cfg.passthrough else opt)
    pools = _partition_pools(len(setup.profiles), cfg)
    ack_registry = transport_mod.WorkerAckRegistry()
    transports = [transport_mod.Transport(setup.weights0, codec=transport,
                                          down_codec=transport_down,
                                          frac=transport_frac,
                                          raw_bytes=setup.model_bytes,
                                          mesh=mesh,
                                          ack_registry=ack_registry)
                  for _ in pools]
    ests = [TimeEstimator(server_freq=server_freq,
                          t_onebatch_server=setup.per_batch_server)
            for _ in pools]
    for tr, est, pool in zip(transports, ests, pools):
        # worker-facing auto: each leaf's tuner prices its OWN estimator,
        # seeded by its pool's advertised nominal rates
        bind_nominal_bandwidth(tr, est, [setup.profiles[i] for i in pool])
    sels = make_pool_selectors(selector, ests,
                               [t.expected_oneway_bytes for t in transports],
                               **(selector_kw or {}))
    for j, pool in enumerate(pools):
        # one population per leaf; cohorts drawn from per-leaf streams
        pop = population_mod.WorkerPopulation()
        ests[j].bind_population(pop)
        server = AggregationServer(
            weights=setup.weights0, loop=loop, estimator=ests[j],
            selector=sels[j], eval_fn=setup.eval_fn,
            model_bytes=setup.model_bytes, aggregator=aggregator, mode=mode,
            epochs_per_round=epochs_per_round, max_rounds=max_rounds,
            target_accuracy=target_accuracy if cfg.passthrough else None,
            async_alpha=async_alpha, async_stale_pow=async_stale_pow,
            async_min_updates=async_min_updates, async_delta=async_delta,
            async_latest_table=async_latest_table, transport=transports[j],
            mesh=mesh, name=f"leaf{j}", population=pop, cohort=cohort,
            cohort_seed=cohort_seed + j,
            server_opt=opt if cfg.passthrough else None)
        for i in pool:
            prof, shard = setup.profiles[i], setup.device_shards[i]
            server.add_worker(FLWorker(
                prof.worker_id, profile=prof, data=shard,
                train_fn=setup.train_fn, loop=loop,
                per_batch_time=setup.per_batch_server * server_freq /
                max(prof.cpu_freq * prof.cpu_prop, 1e-9)))
        topo.attach_leaf(server)
    return loop, topo


def run_fl_topology(setup, *, topology,
                    on_build: Optional[Callable[[Topology], None]] = None,
                    max_events: int = 200_000,
                    checkpoint_every: Optional[int] = None,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_keep: int = 3,
                    resume: bool = False,
                    stop_after_checkpoints: Optional[int] = None,
                    **kw) -> TopologyResult:
    """Build and run one hierarchical FL experiment end to end.  ``kw``
    mirrors ``run_fl``'s per-server kwargs; ``on_build`` runs after
    construction and before the first dispatch (fault schedules and lossy
    links are installed through it; on a ``resume=True`` run it must NOT
    re-apply past fault schedules: the snapshot already carries the
    injected reliability and audit state).
    ``checkpoint_every``/``checkpoint_dir``/``resume`` snapshot and
    restore the FULL topology state at global-version boundaries (the
    leaf version in passthrough, where there is no root counter), as
    ``run_fl``'s do."""
    loop, topo = build_topology(setup, topology=topology, **kw)
    if on_build is not None:
        on_build(topo)
    if resume or checkpoint_every is not None:
        from repro_torch.checkpoint.snapshot import (FederationSnapshot,
                                                     run_checkpointed)
        if topo.cfg.passthrough:
            (only,) = topo.leaves.values()
            version_fn = lambda: only.server.version
        else:
            version_fn = lambda: topo.version
        run_checkpointed(
            loop, topo.start, version_fn,
            lambda: FederationSnapshot.capture_topology(loop, topo),
            lambda snap: snap.restore_topology(loop, topo),
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
            checkpoint_keep=checkpoint_keep, resume=resume,
            max_events=max_events, stop_after=stop_after_checkpoints)
    else:
        topo.start()
        loop.run(max_events=max_events)
    if loop.exhausted:
        raise RuntimeError(
            f"event loop exhausted max_events={max_events} with work "
            "still queued — the run did not complete and the histories "
            "would be silently truncated; shrink the run or raise "
            "max_events")
    topo.finalize()
    return TopologyResult(
        root_history=topo.history,
        leaf_histories={lid: lf.server.history
                        for lid, lf in topo.leaves.items()},
        topology=topo, config=topo.cfg)
