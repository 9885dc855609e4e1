"""Fault injection + elastic worker pool + seeded chaos for the FL runtime
(port of ``repro/runtime/faults.py``).

Failure semantics: a failed worker stops responding (its in-flight training
never completes). The aggregation server's straggler timeout converts the
silence into a ``failed`` profile flag, which every selection policy treats
as exclusion — the paper's worker-selection machinery doubles as the
failure-recovery path. Recovery/join simply (re)registers the worker; the
next selection round picks it up (elastic scaling).

Chaos layer (the fault-tolerance proof harness): a :class:`ChaosSchedule`
samples kill/recover/link-loss events over any hierarchical topology from
one seed — per-tier :class:`~repro_torch.core.transport.LinkReliability` models
(drop/duplicate/retransmit on every worker and server link), worker
kill/recover times, leaf kills, a root kill — and
:func:`audit_chaos_run` closes the books afterwards: history byte
counters against the delivery ledger, EF revert chains against in-flight
dispatches, warehouse tickets against in-flight uplinks, per-receiver
model-version monotonicity, and delta (not raw) resume after a root
failover.  The schedules draw from ``numpy.random.RandomState``, as the
JAX package's do, so one seed replays the same events in both.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import transport as transport_mod
from repro_torch.core.events import EventLoop
from repro_torch.core.server import AggregationServer
from repro_torch.core.worker import FLWorker
from repro_torch.parallel import sharding as psh


@dataclass
class FaultInjector:
    """Schedules worker kill / recover events on the simulation clock."""
    loop: EventLoop
    server: AggregationServer

    def kill_at(self, t: float, worker_id: str):
        def _kill():
            w = self.server.workers.get(worker_id)
            if w is not None:
                w.profile.failed = True
        self.loop.at(t, _kill)

    def recover_at(self, t: float, worker_id: str):
        def _recover():
            w = self.server.workers.get(worker_id)
            if w is not None:
                w.profile.failed = False
        self.loop.at(t, _recover)

    # --- lane-addressed chaos (massive-scale populations) ---
    # Cohort-sampled servers materialize NO per-worker state (no link, no
    # events) for workers outside past cohorts, so the chaos layer kills
    # by population LANE — a stable integer handle every adopted worker
    # has from round 0 — rather than requiring an object to exist.  The
    # lane resolves to a worker id at FIRE time: whichever profile holds
    # the lane then (elastic re-adoption) is the one that dies.

    def kill_lane_at(self, t: float, lane: int):
        def _kill():
            pop = self.server.population
            if pop is not None and 0 <= lane < len(pop):
                pop.profile(lane).failed = True
        self.loop.at(t, _kill)

    def recover_lane_at(self, t: float, lane: int):
        def _recover():
            pop = self.server.population
            if pop is not None and 0 <= lane < len(pop):
                pop.profile(lane).failed = False
        self.loop.at(t, _recover)


@dataclass
class ElasticPool:
    """Workers joining/leaving mid-training (elastic scaling)."""
    loop: EventLoop
    server: AggregationServer

    def join_at(self, t: float, worker: FLWorker):
        def _join():
            self.server.add_worker(worker)
        self.loop.at(t, _join)

    def leave_at(self, t: float, worker_id: str):
        def _leave():
            self.server.remove_worker(worker_id)
        self.loop.at(t, _leave)


@dataclass
class TopologyFaultInjector:
    """Hierarchical fault schedule for a ``core.topology.Topology``: leaf
    *servers* dying (their pool goes silent, in-flight server<->server
    transfers roll back — see ``Topology.kill_leaf``) and their orphaned
    workers re-attaching to a surviving leaf, FogBus2's
    restart-the-container recovery story at the aggregation tier."""
    topology: object       # core.topology.Topology

    def kill_leaf_at(self, t: float, leaf_id: str):
        self.topology.kill_leaf_at(t, leaf_id)

    def kill_root_at(self, t: float):
        """Kill the ROOT aggregator: in-flight server<->server transfers
        roll back and (with ``root_failover``) the senior surviving leaf
        is promoted in place — see ``Topology.kill_root``."""
        self.topology.kill_root_at(t)

    def reattach_workers_at(self, t: float, from_leaf: str, to_leaf: str):
        """Move every worker of a (dead) leaf under a surviving leaf's
        registry.  The topology-wide ``WorkerAckRegistry`` means the new
        leaf's first dispatch to each worker is a delta against the
        worker's actual acked base, not a raw re-send."""
        topo = self.topology

        def _reattach():
            src = topo.leaves[from_leaf].server
            dst = topo.leaves[to_leaf].server
            for w in list(src.workers.values()):
                src.remove_worker(w.worker_id)
                dst.add_worker(w)
        topo.loop.at(t, _reattach)


# --- seeded chaos: loss + kill schedules over a whole topology ---

def inject_link_reliability(transport, reliability,
                            estimator=None) -> None:
    """Attach a lossy-channel model (plus the estimator whose measured
    bandwidth prices retransmit timeouts) and a fresh delivery ledger to
    one transport.  Every transfer on its links now routes through
    ``transport.transmit``'s seeded drop/duplicate/retransmit machinery
    and is recorded for :func:`audit_chaos_run`."""
    transport.reliability = reliability
    transport.rel_estimator = estimator
    transport.audit = transport_mod.TransportAudit()


@dataclass
class ChaosSchedule:
    """One seed -> one deterministic chaos scenario over any topology.

    ``apply(topo)`` injects a :class:`LinkReliability` (drop/duplicate
    probability ``drop_p``/``dup_p``) on every worker-tier transport and
    on the root's server<->server transport, then samples kill/recover
    events on the simulation clock from ``numpy.RandomState(seed)``:
    ``n_worker_kills`` workers die at uniform times in ``(0, horizon)``
    (each recovering one straggler-budget later when ``worker_recover``),
    ``n_leaf_kills`` leaf servers die, and with ``kill_root`` the root
    itself dies mid-run (passthrough topologies, having no separate root
    or server wire, skip the leaf/root events).  A ``drop_p`` of 0 still
    engages the full channel + ledger machinery, so the auditor's books
    close on lossless chaos runs too."""
    seed: int
    drop_p: float = 0.1
    dup_p: float = 0.05
    horizon: float = 5.0
    n_worker_kills: int = 1
    worker_recover: bool = True
    recover_after: float = 2.0
    n_leaf_kills: int = 0
    kill_root: bool = False
    events: List[tuple] = field(default_factory=list)

    def apply(self, topo) -> List[tuple]:
        rng = np.random.RandomState(self.seed)
        self.events = []
        for j, (lid, lf) in enumerate(sorted(topo.leaves.items())):
            inject_link_reliability(
                lf.server.transport,
                transport_mod.LinkReliability(
                    drop_p=self.drop_p, dup_p=self.dup_p,
                    seed=self.seed * 1009 + j),
                estimator=lf.server.est)
        if topo.transport is not None:
            inject_link_reliability(
                topo.transport,
                transport_mod.LinkReliability(
                    drop_p=self.drop_p, dup_p=self.dup_p,
                    seed=self.seed * 1009 + 997))
        # worker kills (+ recoveries) anywhere in the federation
        pool = [(lid, w.worker_id)
                for lid, lf in sorted(topo.leaves.items())
                for w in lf.server.workers.values()]
        for _ in range(self.n_worker_kills):
            if not pool:
                break
            lid, wid = pool[rng.randint(len(pool))]
            t_kill = float(rng.uniform(0.05, self.horizon))
            inj = FaultInjector(topo.loop, topo.leaves[lid].server)
            inj.kill_at(t_kill, wid)
            self.events.append(("kill_worker", t_kill, wid))
            if self.worker_recover:
                t_rec = t_kill + float(rng.uniform(0.5, 1.5)) \
                    * self.recover_after
                inj.recover_at(t_rec, wid)
                self.events.append(("recover_worker", t_rec, wid))
        if not topo.cfg.passthrough:
            lids = sorted(topo.leaves)
            for _ in range(min(self.n_leaf_kills, len(lids))):
                lid = lids.pop(rng.randint(len(lids)))
                t_kill = float(rng.uniform(0.05, self.horizon))
                topo.kill_leaf_at(t_kill, lid)
                self.events.append(("kill_leaf", t_kill, lid))
            if self.kill_root:
                t_kill = float(rng.uniform(0.05, self.horizon))
                topo.kill_root_at(t_kill)
                self.events.append(("kill_root", t_kill, None))
        return self.events


def _audit_history(history, label: str) -> None:
    for prev, cur in zip(history, history[1:]):
        assert cur.time >= prev.time, \
            f"{label}: time ran backwards at v{cur.version}"
        assert cur.version >= prev.version, \
            f"{label}: version ran backwards at t={cur.time}"
        assert cur.up_bytes >= prev.up_bytes \
            and cur.down_bytes >= prev.down_bytes, \
            f"{label}: byte counters ran backwards at v{cur.version}"
        assert cur.retransmits >= prev.retransmits, \
            f"{label}: retransmit counter ran backwards at v{cur.version}"


def _finite(vec) -> bool:
    """Every element finite (a ``Sharded`` vector: every piece)."""
    pieces = vec.shards if isinstance(vec, psh.Sharded) else (vec,)
    return all(bool(torch.isfinite(p).all()) for p in pieces)


def audit_chaos_run(topo) -> Dict[str, object]:
    """Post-run global invariant auditor for one (chaos or not) topology
    run.  Raises ``AssertionError`` on the first violated invariant;
    returns summary stats otherwise.

    Invariants:
      1. every history (root + each leaf) is monotone in time, version,
         byte counters, and retransmit count, and never exceeds its
         server's running totals;
      2. the delivery ledger closes: bytes a server *counted* up are a
         subset of bytes the channel *delivered* (a deduplicated copy can
         never be double-counted), bytes the channel sent down were all
         counted at dispatch, and the transport's retransmit counter
         equals the ledger's;
      3. the EF books close: every revert-chain entry in every (possibly
         shared) ``WorkerAckState`` belongs to exactly one link's pending
         in-flight dispatch, uplink residuals exist only on EF codecs,
         downlink residuals only on EF downlink codecs, and all residuals
         are finite;
      4. no stranded warehouse tickets: each worker's live one-time
         credentials (and stored response payloads) correspond exactly to
         its in-flight uplinks;
      5. model versions are monotone per receiver: the sequence of
         versions each worker fetched (and each leaf installed) never
         decreases;
      6. after a root failover, the promoted root's first dispatch to
         every leaf with an acked base was a delta, not a raw re-sync."""
    transports = [(f"leaf:{lid}", lf.server.transport,
                   lf.server.total_up_bytes, lf.server.total_down_bytes)
                  for lid, lf in sorted(topo.leaves.items())]
    if topo.transport is not None:
        transports.append(("root", topo.transport, topo.total_up_bytes,
                           topo.total_down_bytes))

    # 1 — histories
    for lid, lf in sorted(topo.leaves.items()):
        _audit_history(lf.server.history, f"leaf:{lid}")
        last = lf.server.history[-1]
        assert last.up_bytes <= lf.server.total_up_bytes
        assert last.down_bytes <= lf.server.total_down_bytes
    _audit_history(topo.history, "root")
    if topo.history and topo.transport is not None:
        assert topo.history[-1].up_bytes <= topo.total_up_bytes
        assert topo.history[-1].down_bytes <= topo.total_down_bytes

    # 2 — delivery ledger
    retx_total = 0
    for name, tr, up, down in transports:
        aud = tr.audit
        if aud is None:
            continue
        retx_total += tr.total_retransmits
        assert up <= aud.delivered_bytes["up"], \
            (f"{name}: counted {up} uplink bytes but the channel only "
             f"delivered {aud.delivered_bytes['up']} — a duplicate or "
             "undelivered payload was counted")
        assert aud.sent_bytes["down"] <= down, \
            (f"{name}: channel sent {aud.sent_bytes['down']} downlink "
             f"bytes but only {down} were counted at dispatch")
        assert tr.total_retransmits == aud.retx_count, \
            f"{name}: retransmit counter diverged from the ledger"

    # 3 — EF books (revert-chain closure over possibly-shared ack states)
    states: Dict[int, object] = {}
    links_by_state = defaultdict(list)
    for name, tr, _, _ in transports:
        for wid, link in tr._links.items():
            states[id(link._ack)] = link._ack
            links_by_state[id(link._ack)].append((name, link))
            if not tr.spec_up.ef:
                assert link.residual is None, \
                    f"{name}/{wid}: uplink residual on a non-EF codec"
            elif link.residual is not None:
                assert _finite(link.residual), \
                    f"{name}/{wid}: non-finite uplink EF residual"
            if not tr.spec_down.ef:
                assert link.down_residual is None, \
                    f"{name}/{wid}: downlink residual on a non-EF codec"
            elif link.down_residual is not None:
                assert _finite(link.down_residual), \
                    f"{name}/{wid}: non-finite downlink EF residual"
    for sid, st in states.items():
        pend = [l._pending_down[1] for _, l in links_by_state[sid]
                if l._pending_down is not None
                and l._pending_down[1] is not None]
        assert len(st._entries) == len(pend), \
            (f"EF revert chain leak: {len(st._entries)} chain entries vs "
             f"{len(pend)} pending dispatches on "
             f"{[n for n, _ in links_by_state[sid]]}")
        for e in st._entries:
            assert any(e is p for p in pend), \
                "EF revert-chain entry belongs to no pending dispatch"

    # 4 — warehouse tickets
    for lid, lf in sorted(topo.leaves.items()):
        for w in lf.server.workers.values():
            inflight = {entry[0] for entry in w._inflight.values()}
            live = set(w.warehouse._tickets)
            assert live == inflight, \
                (f"worker {w.worker_id}: live tickets {live} != in-flight "
                 f"uplinks {inflight} — a credential leaked or was lost")
            stored = set(w.warehouse._meta)
            ticketed = set(w.warehouse._tickets.values())
            assert stored == ticketed, \
                (f"worker {w.worker_id}: stored payloads {stored} != "
                 f"ticketed {ticketed} — a response payload leaked")

    # 5 — per-receiver version monotonicity
    for name, tr, _, _ in transports:
        if tr.audit is None:
            continue
        for wid, versions in tr.audit.fetch_versions.items():
            assert versions == sorted(versions), \
                f"{name}/{wid}: fetched model versions not monotone"

    # 6 — delta resume after failover (fixed-codec transports only: an
    # auto backbone may legitimately re-provision raw when its pricing
    # rule picks the dense codec for a fat server<->server link)
    if topo.failovers and topo.transport is not None \
            and topo.transport.spec_down.delta \
            and not topo.transport.auto_down:
        for lid, codec, had_base in topo.failover_dispatches:
            if had_base:
                assert codec != "raw", \
                    (f"failover re-provisioned {lid} with a raw re-sync "
                     "despite a surviving acked base")

    return {
        "failovers": topo.failovers,
        "retransmits": retx_total,
        "root_versions": topo.version,
        "leaf_versions": {lid: lf.server.version
                          for lid, lf in topo.leaves.items()},
        "total_up_bytes": sum(t[2] for t in transports),
        "total_down_bytes": sum(t[3] for t in transports),
    }
