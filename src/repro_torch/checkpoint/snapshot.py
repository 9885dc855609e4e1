"""Crash-consistent snapshot/restore of a FULL federation's state (port of
``repro/checkpoint/snapshot.py``).

:class:`FederationSnapshot` captures everything a running federation,
single-server (``experiment.run_fl``) or hierarchical
(``topology.run_fl_topology``), needs to continue bit-identically after
the process dies: server flat buffers and row-window occupancy, per-link
transport state (``tx_base``/``acked_base``, both EF residuals and their
revert chains, lossy-channel RNG/sequence/delivered-set, autotuner
per-link state), the shared :class:`WorkerAckRegistry`, estimator
measurements, population lanes, selection/budget state, the server
optimizer's moments, history counters, and the event-loop clock plus
every pending timer.

It re-derives (never serializes) the packed server mirrors and per-round
pack caches (``_server_flat``/``_down_vec``), the server optimizer's
``prev`` anchor (bitwise-same repacks of the restored weights), population
views and the links themselves.

Capture NEVER mutates the live federation: the run continues after a
checkpoint save.  All cancel-with-credit algebra below operates on
captured *images* (plain dicts/lists mirroring the live structures).

Tensors.  The live state's tensors sit on the setup's device and several
update in place after a capture (the merge writes its server buffer and
the optimizer's moments, an EF encode its residual).  So a capture ends
with one host copy of the whole image (:func:`_copy_graph`): one copy per
live tensor, keyed by its ``id``, so that two references stay one object
(an ``EncodedVec.base`` shared by the responses pinned to one model, a
payload held by a link and its ack cell), with one sync for the batch.
A restore moves each tensor once to the restoring federation's device,
again as one batch.  A sharded server's pieces (``Sharded`` row buffer,
optimizer moments, every link vector, ack image and pinned payload) are
tensors of the image like any other, so the same batch copies every
shard, and each ``Sharded`` stays one object, shared where it was;
restore puts each piece back on its own mesh device.  A snapshot
therefore pickles with no card in the reader, and restoring one twice
gives two independent federations.

Event replay invariant.  Every ``resume_*`` helper in the core consumes
exactly one ``loop.schedule_abs`` call; restore replays serialized event
records sorted by their original ``(time, seq)`` onto a fresh loop, so
relative tie-break order (and therefore the whole continuation) is
preserved, with deadlines replayed as exact absolute floats.

Reliable legs serialize verbatim and resume bit-identically.  Lossy
legs (``rec["ev"] is None``: their pending retransmit timers are
closures the snapshot cannot carry) are *cancelled-with-credit* on the
images instead: the encode's EF mass is credited back, the downlink
revert chain unlinked, tickets revoked, and the instruction re-kicked
fresh after restore.  The chaos tier's correctness bar is the audit
ledger (``runtime.faults.audit_chaos_run``), not bit identity, and both
sides of its closing inequalities only grow under this scheme.

Root-failover state (``topo.failovers > 0``) is not snapshottable: the
promoted root's transport was rebuilt mid-run and the pre-failover
ledger cannot be reconstructed, so :meth:`capture_topology` raises.
"""
from __future__ import annotations

import io
import itertools
import pickle
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import selection as selection_mod
from repro_torch.core import transport as T
from repro_torch.parallel import sharding as psh

# population lanes restored wholesale (core/population.py mirror lanes +
# measurement + bookkeeping lanes, in declaration order)
_LANES = ("cpu_freq", "cpu_prop", "bandwidth", "n_batches", "failed",
          "registered", "t_one_meas", "tx_t", "tx_bytes", "ack_version",
          "staleness", "score", "ef_norm")

_MISSING = "__missing__"       # selector attr never set (pre-first-select)


# --- tensors across the process boundary ---
def _copy_graph(obj, move: Callable[[list], list], place: bool = False):
    """A copy of the object graph ``obj`` with each distinct tensor ``t``
    replaced by ``move(tensors)[i]``.  One pickle pass collects the
    tensors, one entry per live tensor keyed by ``id``; ``move`` copies
    them as one batch; the unpickle rebuilds the graph around the copies.
    Every object shared inside ``obj`` stays shared in the copy.  A
    ``Sharded`` travels as its mesh and its pieces (tensors of the batch)
    and comes back as one new ``Sharded`` per distinct one, shared where
    it was (an ack chain's residual, a base pinned by several payloads);
    with ``place`` each piece then goes to its own mesh device
    (``to_mesh``): ``move`` brought every tensor to one device."""
    tensors, index, specs, sharded = [], {}, [], {}

    def tensor_id(o):
        i = index.get(id(o))
        if i is None:
            i = index[id(o)] = len(tensors)
            tensors.append(o)
        return i

    class _Out(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor):
                return ("t", tensor_id(o))
            if isinstance(o, psh.Sharded):
                j = sharded.get(id(o))
                if j is None:
                    j = sharded[id(o)] = len(specs)
                    specs.append((o.mesh, [tensor_id(p) for p in o.shards]))
                return ("s", j)
            return None

    buf = io.BytesIO()
    _Out(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    moved = move(tensors)
    built = {}

    class _In(pickle.Unpickler):
        def persistent_load(self, pid):
            kind, i = pid
            if kind == "t":
                return moved[i]
            if i not in built:
                mesh, idx = specs[i]
                s = psh.Sharded([moved[t] for t in idx], mesh)
                built[i] = s.to_mesh() if place else s
            return built[i]

    buf.seek(0)
    return _In(buf).load()


def _to_host(tensors: list) -> list:
    """Host copies of ``tensors``: device tensors through pinned memory
    without blocking, then one sync per device for the batch."""
    out, devices = [], set()
    for t in tensors:
        t = t.detach()
        if t.device.type == "cpu":
            out.append(t.clone())
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
        devices.add(t.device)
    for d in devices:
        torch.cuda.synchronize(d)
    return out


def _to_device(device: torch.device) -> Callable[[list], list]:
    """A ``move`` for :func:`_copy_graph`: each host tensor copied once to
    ``device`` (through pinned memory without blocking, one sync for the
    batch on a card)."""
    def move(tensors: list) -> list:
        if device.type == "cpu":
            return [t.clone() for t in tensors]
        out = [t.pin_memory().to(device, non_blocking=True)
               for t in tensors]
        torch.cuda.synchronize(device)
        return out
    return move


def _counter_pos(ctr) -> int:
    """The next value of an ``itertools.count(start)`` without consuming
    it (its repr is ``count(n)``)."""
    r = repr(ctr)
    return int(r[r.index("(") + 1:r.index(")")])


class _Capture:
    """Per-capture registries: ack-state images keyed by token (shared
    states: one registry entry however many links share it), image
    entry-cells keyed by the live cell's id (so a link's pending-down
    image can reference ITS image cell and pickle's memo keeps the
    identity the restore-side ``WorkerAckState`` algebra depends on),
    and the cancel-with-credit worklists filled by the leg walk."""

    def __init__(self):
        self.ack_tokens = {}      # id(live WorkerAckState) -> token
        self.ack_images = {}      # token -> image dict
        self.cell_images = {}     # id(live entry cell) -> image cell
        self.link_cancels = {}    # id(live Link) -> [(kind, payload)]
        self.wh_drops = {}        # id(live DataWarehouse) -> [ticket]
        self.busy_override = {}   # (server_name, wid) -> bool

    def ack_token(self, st) -> int:
        tok = self.ack_tokens.get(id(st))
        if tok is None:
            tok = self.ack_tokens[id(st)] = len(self.ack_tokens)
            cells = []
            for e in st._entries:
                img = list(e)
                self.cell_images[id(e)] = img
                cells.append(img)
            self.ack_images[tok] = {"acked_base": st.acked_base,
                                    "down_residual": st.down_residual,
                                    "entries": cells}
        return tok

    def cancel_fetch(self, link, payload) -> None:
        self.link_cancels.setdefault(id(link), []).append(("fetch", payload))

    def cancel_send(self, link, payload) -> None:
        self.link_cancels.setdefault(id(link), []).append(("send", payload))


def _img_ack_cancel(ack_img: dict, cell: list) -> None:
    """Image mirror of ``WorkerAckState.cancel``: unlink one in-flight
    encode from the captured revert chain."""
    ents = ack_img["entries"]
    for i, e in enumerate(ents):
        if e is cell:
            break
    else:
        return
    ents.pop(i)
    if i == len(ents):                    # was the newest encode
        ack_img["down_residual"] = cell[0]
    else:
        ents[i][0] = cell[0]


def _img_credit_uplink(link_img: dict, payload) -> None:
    """Image mirror of ``Link.restore_uplink``: credit a cancelled
    uplink's encoded mass back into the captured EF residual (new
    tensors: the live residual is never written)."""
    spec = T.CODECS[payload.codec]
    ur = link_img["up_restore"]
    if ur is not None and ur[0] is payload:
        link_img["up_restore"] = None
        if not spec.ef:
            r = link_img["residual"]
            link_img["residual"] = ur[1] if r is None else r + ur[1]
            return
    if not spec.ef:
        return
    data = payload.data
    recon = T._dequant(*data) if spec.quantize else data
    r = link_img["residual"]
    link_img["residual"] = recon if r is None else r + recon


# --- transport capture/restore ---
def _capture_link(caps: _Capture, link) -> dict:
    tok = caps.ack_token(link._ack)
    img = {
        "tok": tok,
        "tx_base": link.tx_base,
        "residual": link.residual,
        "pending_down": None,
        "up_restore": (None if link._up_restore is None
                       else [link._up_restore[0], link._up_restore[1]]),
        "rel": (("inherit", None) if link._reliability is T._REL_INHERIT
                else ("value", link._reliability)),
        "chan": None,
    }
    pd = link._pending_down
    if pd is not None:
        payload, entry, base = pd
        cell = caps.cell_images[id(entry)] if entry is not None else None
        img["pending_down"] = [payload, cell, base]
    ch = link._chan
    if ch is not None:
        img["chan"] = {"rng": ch.rng.get_state(), "seq": ch._seq,
                       "delivered": set(ch.delivered)}
    ack_img = caps.ack_images[tok]
    for kind, payload in caps.link_cancels.pop(id(link), ()):
        if kind == "fetch":
            pdi = img["pending_down"]
            if pdi is not None and pdi[0] is payload:
                img["pending_down"] = None
                if pdi[1] is not None:
                    _img_ack_cancel(ack_img, pdi[1])
        else:
            _img_credit_uplink(img, payload)
    return img


def _capture_transport(caps: _Capture, tr) -> dict:
    # plain iteration: Transport.link() is move-to-end LRU bookkeeping
    # and must not run during capture (or restore)
    links = {wid: _capture_link(caps, ln) for wid, ln in tr._links.items()}
    tun = tr.tuner
    return {
        "links": links,
        "evictions": tr.total_link_evictions,
        "retransmits": tr.total_retransmits,
        "closed": tr.closed,
        "reliability": tr.reliability,
        "audit": tr.audit,
        "had_rel_est": tr.rel_estimator is not None,
        "tuner": None if tun is None else {
            "rounds": tun.rounds, "frac_i": tun._frac_i,
            "flat_streak": tun._flat_streak, "last_acc": tun._last_acc},
    }


def _restore_transport(tr, img: dict, ack_states: dict,
                       rel_estimator) -> None:
    tr._links.clear()
    for wid, li in img["links"].items():
        ln = T.Link(tr, ack_states[li["tok"]], wid)
        ln.tx_base = li["tx_base"]
        ln.residual = li["residual"]
        pdi = li["pending_down"]
        if pdi is not None:
            # pdi[1] IS a cell of ack_states[tok]._entries (pickle memo),
            # so the live complete/cancel identity algebra works unchanged
            ln._pending_down = (pdi[0], pdi[1], pdi[2])
        uri = li["up_restore"]
        if uri is not None:
            ln._up_restore = (uri[0], uri[1])
        kind, val = li["rel"]
        if kind == "value":
            ln._reliability = val
        chi = li["chan"]
        if chi is not None:
            ch = T._Channel(0)
            ch.rng.set_state(chi["rng"])
            ch._seq = chi["seq"]
            ch.delivered = set(chi["delivered"])
            ln._chan = ch
        tr._links[wid] = ln
    tr.total_link_evictions = img["evictions"]
    tr.total_retransmits = img["retransmits"]
    tr.closed = img["closed"]
    tr.reliability = img["reliability"]
    tr.audit = img["audit"]
    tr.rel_estimator = rel_estimator if img["had_rel_est"] else None
    ti, tun = img["tuner"], tr.tuner
    if ti is not None and tun is not None:
        tun.rounds = ti["rounds"]
        tun._frac_i = ti["frac_i"]
        tun._flat_streak = ti["flat_streak"]
        tun._last_acc = ti["last_acc"]
    # per-round pack cache: re-derived (bitwise-same repack of the
    # restored weights dict)
    tr._down_tree = None
    tr._down_vec = None


# --- warehouse / selector / population / flat-state capture ---
def _capture_warehouse(caps: _Capture, wh) -> dict:
    for uid, stname in wh._meta.items():
        if stname != "ram":
            raise NotImplementedError(
                f"snapshot supports only ram-backed warehouse entries; "
                f"{uid!r} lives in {stname!r}")
    d = dict(wh.storages["ram"]._d)
    meta = dict(wh._meta)
    tickets = dict(wh._tickets)
    for ticket in caps.wh_drops.pop(id(wh), ()):
        uid = tickets.pop(ticket, None)
        if uid is not None:         # cancelled uplink: revoke + delete
            d.pop(uid, None)
            meta.pop(uid, None)
    # the uid counter's position, so restored puts continue the sequence
    return {"d": d, "meta": meta, "tickets": tickets,
            "ctr": _counter_pos(wh._ctr)}


def _restore_warehouse(wh, img: dict) -> None:
    wh.storages["ram"]._d = dict(img["d"])
    wh._meta = dict(img["meta"])
    wh._tickets = dict(img["tickets"])
    wh._ctr = itertools.count(img["ctr"])


def _capture_selector(sel) -> dict:
    if isinstance(sel, selection_mod.RandomSelector):
        return {"rng": sel.rng.getstate()}
    if isinstance(sel, selection_mod.RMinRMaxSelector):
        return {"rmin": sel.rmin, "rmax": sel.rmax,
                "last_acc": sel._last_acc,
                "pending_bytes": sel._pending_bytes}
    if isinstance(sel, selection_mod.TimeBasedSelector):
        pending = getattr(sel, "_pending", _MISSING)
        if pending is _MISSING:
            p_img = _MISSING
        elif pending is None:
            p_img = None
        elif isinstance(pending, list):
            p_img = ("ids", [w.worker_id for w in pending])
        else:                       # PopulationView
            p_img = ("view", np.array(pending.lanes))
        selmask = getattr(sel, "_pending_selmask", _MISSING)
        if selmask is not _MISSING and selmask is not None:
            selmask = np.array(selmask)
        return {"T": sel.T, "last_acc": sel._last_acc,
                "last_selected": list(sel._last_selected),
                "pending_bytes": sel._pending_bytes,
                "pending": p_img, "pending_selmask": selmask}
    return {}                       # AllSelector: stateless


def _restore_selector(sel, img: dict, srv) -> None:
    if isinstance(sel, selection_mod.RandomSelector):
        sel.rng.setstate(img["rng"])
    elif isinstance(sel, selection_mod.RMinRMaxSelector):
        sel.rmin = img["rmin"]
        sel.rmax = img["rmax"]
        sel._last_acc = img["last_acc"]
        sel._pending_bytes = img["pending_bytes"]
    elif isinstance(sel, selection_mod.TimeBasedSelector):
        sel.T = img["T"]
        sel._last_acc = img["last_acc"]
        sel._last_selected = list(img["last_selected"])
        sel._pending_bytes = img["pending_bytes"]
        p_img = img["pending"]
        if p_img is _MISSING:
            pass                     # never selected: fresh object matches
        elif p_img is None:
            sel._pending = None
        elif p_img[0] == "view":
            from repro_torch.core.population import PopulationView
            sel._pending = PopulationView(srv.population, p_img[1])
        else:
            sel._pending = [srv.workers[wid].profile for wid in p_img[1]]
        if img["pending_selmask"] is not _MISSING:
            sel._pending_selmask = img["pending_selmask"]


def _capture_population(pop) -> Optional[dict]:
    if pop is None:
        return None
    n = pop.size
    return {"size": n,
            "lanes": {name: np.array(getattr(pop, name)[:n])
                      for name in _LANES}}


def _restore_population(pop, img: Optional[dict]) -> None:
    if img is None or pop is None:
        return
    n = img["size"]
    if pop.size != n:                # same build, same adoption order
        raise ValueError(f"population of {pop.size} restored from a "
                         f"snapshot of {n}")
    failed = img["lanes"]["failed"]
    for i in range(n):
        # through the profile so the object attr and the lane stay in sync
        pop._profiles[i].failed = bool(failed[i])
    for name, arr in img["lanes"].items():
        getattr(pop, name)[:n] = arr


def _capture_flat(fl) -> Optional[dict]:
    if fl is None:
        return None
    return {"rows": fl._rows, "free": list(fl._free),
            "next_row": fl._next_row, "dirty": set(fl._dirty)}


def _restore_flat(fl, img: Optional[dict]) -> None:
    if img is None or fl is None:
        return
    # a sharded row buffer's pieces are back on their devices (_on)
    fl._rows = img["rows"]
    fl._free = list(img["free"])
    fl._next_row = img["next_row"]
    fl._dirty = set(img["dirty"])
    # packed server mirror: re-derived (bitwise-same repack)
    fl._server_flat = None
    fl._server_tree = None


# --- server capture/restore ---
def _capture_server(caps: _Capture, srv) -> dict:
    workers_img = {}
    for wid, w in srv.workers.items():
        busy = caps.busy_override.get((srv.name, wid), w.busy)
        workers_img[wid] = {
            "busy": busy, "warehouse": _capture_warehouse(caps, w.warehouse)}
    return {
        "weights": srv.weights,
        "version": srv.version,
        "round_id": srv._round_id,
        "round_open": srv._round_open,
        "timeout_rid": srv._timeout_rid,
        "done": srv.done,
        "started": srv._started,
        "hold": srv._hold,
        "held": list(srv._held),
        "pending_dispatch": srv._pending_dispatch,
        "outstanding": set(srv._outstanding),
        "inflight_w": set(srv._inflight_w),
        "total_up": srv.total_up_bytes,
        "total_down": srv.total_down_bytes,
        "history": list(srv.history),
        "latest": dict(srv._latest),
        "dispatch_base": dict(srv._dispatch_base),
        "cache": list(srv._cache),
        "row_of": dict(srv._row_of),
        "cohort_rng": (srv._cohort_rng.getstate()
                       if srv._cohort_rng is not None else None),
        "selector": _capture_selector(srv.selector),
        "est": {"t_one": dict(srv.est._measured_t_one),
                "tx": dict(srv.est._measured_tx)},
        "population": _capture_population(srv.population),
        "flat": _capture_flat(srv._flat),
        # optimizer moments only: the packed prev anchor is re-derived on
        # restore (a bitwise-same repack of the restored weights)
        "server_opt": (srv.server_opt.capture()
                       if srv.server_opt is not None else None),
        "transport": _capture_transport(caps, srv.transport),
        "warehouse": _capture_warehouse(caps, srv.warehouse),
        "workers": workers_img,
    }


def _restore_server(srv, img: dict, ack_states: dict) -> None:
    srv.weights = img["weights"]
    srv.version = img["version"]
    srv._round_id = img["round_id"]
    srv._round_open = img["round_open"]
    srv._timeout_rid = img["timeout_rid"]
    srv.done = img["done"]
    srv._started = img["started"]
    srv._hold = img["hold"]
    srv._held = list(img["held"])
    srv._pending_dispatch = img["pending_dispatch"]
    srv._outstanding = set(img["outstanding"])
    srv._inflight_w = set(img["inflight_w"])
    srv.total_up_bytes = img["total_up"]
    srv.total_down_bytes = img["total_down"]
    srv.history = list(img["history"])
    srv._latest = dict(img["latest"])
    srv._dispatch_base = dict(img["dispatch_base"])
    srv._cache = list(img["cache"])
    srv._row_of = dict(img["row_of"])
    if img["cohort_rng"] is not None:
        srv._cohort_rng.setstate(img["cohort_rng"])
    _restore_selector(srv.selector, img["selector"], srv)
    srv.est._measured_t_one = dict(img["est"]["t_one"])
    srv.est._measured_tx = dict(img["est"]["tx"])
    _restore_population(srv.population, img["population"])
    srv._profiles_view = None
    _restore_flat(srv._flat, img["flat"])
    if img["server_opt"] is not None and srv.server_opt is not None:
        srv.server_opt.restore(img["server_opt"])
    _restore_transport(srv.transport, img["transport"], ack_states, srv.est)
    _restore_warehouse(srv.warehouse, img["warehouse"])
    srv._timeout_ev = None
    srv._noop_ev = None
    for wid, wimg in img["workers"].items():
        w = srv.workers[wid]
        w.busy = wimg["busy"]
        _restore_warehouse(w.warehouse, wimg["warehouse"])
        w._conv.clear()
        w._fetching.clear()
        w._inflight.clear()


# --- pending-event walkers ---
def _walk_server_legs(caps: _Capture, srv, events: list,
                      rekicks: list) -> None:
    """One event record per live in-flight worker leg; lossy legs (no
    serializable event) become image-cancels plus a re-kick."""
    ptr = srv.pointer
    for wid, w in srv.workers.items():
        rec = w._conv.get(ptr)
        if rec is None:
            continue
        ev = rec["ev"]
        if ev is not None and ev.cancelled:
            continue                  # dead leg: fires as a no-op anyway
        if ev is not None:
            events.append({"kind": "worker_leg", "server": srv.name,
                           "wid": wid, "t": ev.time, "seq": ev.seq,
                           "rec": {k: v for k, v in rec.items()
                                   if k != "ev"}})
            continue
        phase = rec["phase"]
        if phase == "fetch":
            down, link = w._fetching[ptr]
            caps.cancel_fetch(link, down)
        elif phase == "send":
            ticket, up, link = w._inflight[ptr]
            caps.cancel_send(link, up)
            caps.wh_drops.setdefault(id(w.warehouse), []).append(ticket)
        else:
            raise AssertionError(
                f"eventless {phase!r} leg cannot exist: train legs are "
                "plain schedules")
        caps.busy_override[(srv.name, wid)] = False
        rekicks.append(("train", srv.name, wid))


def _walk_server_timers(srv, events: list) -> None:
    ev = srv._noop_ev
    if ev is not None and not ev.cancelled:
        events.append({"kind": "noop", "server": srv.name,
                       "t": ev.time, "seq": ev.seq})
    ev = srv._timeout_ev
    if (ev is not None and not ev.cancelled
            and srv._timeout_rid == srv._round_id and srv._round_open):
        # stale timers (round already closed) fire as no-ops: dropping
        # them from the snapshot is behaviour-identical
        events.append({"kind": "straggler", "server": srv.name,
                       "rid": srv._timeout_rid, "t": ev.time, "seq": ev.seq})


def _walk_topology_legs(caps: _Capture, topo, events: list, rekicks: list,
                        n_credit: dict) -> None:
    for lid, lf in topo.leaves.items():
        rec = lf.push_rec
        if rec is not None and (rec["ev"] is None or not rec["ev"].cancelled):
            ev = rec["ev"]
            if ev is not None:
                events.append({"kind": "push", "lid": lid,
                               "t": ev.time, "seq": ev.seq,
                               "rec": {k: v for k, v in rec.items()
                                       if k != "ev"}})
            else:                     # lossy backbone: cancel-with-credit
                caps.cancel_send(lf.link, rec["payload"])
                n_credit[lid] = n_credit.get(lid, 0) + rec["n_data"]
                rekicks.append(("push", lid))
        rec = lf.fan_rec
        if rec is not None and (rec["ev"] is None or not rec["ev"].cancelled):
            ev = rec["ev"]
            if ev is not None:
                events.append({"kind": "fan", "lid": lid,
                               "t": ev.time, "seq": ev.seq,
                               "rec": {k: v for k, v in rec.items()
                                       if k != "ev"}})
            else:
                caps.cancel_fetch(lf.link, rec["payload"])
                rekicks.append(("fan", lid))
        ev = lf.done_settling
        if ev is not None and not ev.cancelled:
            events.append({"kind": "settle", "lid": lid,
                           "t": ev.time, "seq": ev.seq})


def drive_checkpointed(loop, mgr, version_fn, capture_fn, *, every: int,
                       max_events: int,
                       stop_after: Optional[int] = None) -> int:
    """Run ``loop`` to completion in checkpoint-boundary segments: pause
    exactly when ``version_fn()`` crosses the next multiple of ``every``
    (a consistent round boundary: ``break_when`` fires between events),
    save a snapshot, continue.  ``max_events`` is accounted ACROSS
    segments, so a checkpointed run gets the same total budget as an
    uninterrupted one.  ``stop_after`` aborts right after that many
    saves (the kill-at-checkpoint test harness; the caller's run is then
    truncated on purpose).  Returns the number of snapshots saved."""
    if every <= 0:
        raise ValueError(f"checkpoint_every must be positive, got {every}")
    left = max_events
    saved = 0
    while True:
        boundary = (version_fn() // every + 1) * every
        loop.run(max_events=left,
                 break_when=lambda b=boundary: version_fn() >= b)
        left -= loop.events_run
        if loop._stopped or not loop._q:
            return saved
        if loop.exhausted or left <= 0:
            loop.exhausted = True     # work queued, budget gone
            return saved
        mgr.save(version_fn(), capture_fn(), raw=True)
        saved += 1
        if stop_after is not None and saved >= stop_after:
            return saved


def run_checkpointed(loop, start, version_fn, capture_fn, restore_fn, *,
                     checkpoint_every: Optional[int],
                     checkpoint_dir: Optional[str], checkpoint_keep: int,
                     resume: bool, max_events: int,
                     stop_after: Optional[int]) -> None:
    """The checkpoint arguments of ``run_fl`` and ``run_fl_topology``:
    restore the newest readable snapshot (``resume``) or ``start()`` the
    federation, then drive the loop in checkpointed segments (or plainly
    when ``checkpoint_every`` is None)."""
    from .manager import CheckpointManager
    if checkpoint_dir is None:
        raise ValueError("checkpointing needs checkpoint_dir")
    mgr = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
    if resume:
        got = mgr.restore_latest()
        if got is None:
            raise FileNotFoundError(
                f"resume=True but no readable checkpoint in "
                f"{checkpoint_dir}")
        restore_fn(got[1])
    else:
        start()
    if checkpoint_every is not None:
        drive_checkpointed(loop, mgr, version_fn, capture_fn,
                           every=checkpoint_every, max_events=max_events,
                           stop_after=stop_after)
    else:
        loop.run(max_events=max_events)


def _build_ack_states(images: dict) -> dict:
    states = {}
    for tok, img in images.items():
        st = T.WorkerAckState()
        st.acked_base = img["acked_base"]
        st.down_residual = img["down_residual"]
        st._entries = img["entries"]     # cells shared with pending_downs
        states[tok] = st
    return states


@dataclass
class FederationSnapshot:
    """One crash-consistent image of a whole federation, taken at a
    round boundary (or any quiescent point between events).

    ``state``, ``events`` and ``rekicks`` are one object graph of host
    data: one ``pickle.dumps`` preserves every identity the core's
    ``is``-checks rely on (a conv record's payload IS the link's
    pending-down payload; a leaf's ``merged_base`` IS the pinned snapshot
    dict), which is why the checkpoint manager stores snapshots in raw
    mode."""

    kind: str                 # "run" | "topology"
    clock: float              # loop.now at capture
    state: dict
    events: list              # serialized pending events, (t, seq)-sorted
    rekicks: list             # re-dispatch instructions for cancelled legs

    # --- capture ---
    @classmethod
    def _detached(cls, kind, clock, state, events, rekicks):
        """The snapshot of a captured image, every tensor copied to the
        host in one batch (the live tensors update in place later)."""
        events.sort(key=lambda r: (r["t"], r["seq"]))
        state, events, rekicks = _copy_graph((state, events, rekicks),
                                             _to_host)
        return cls(kind, clock, state, events, rekicks)

    @classmethod
    def capture_run(cls, loop, server) -> "FederationSnapshot":
        caps = _Capture()
        events, rekicks = [], []
        _walk_server_legs(caps, server, events, rekicks)
        _walk_server_timers(server, events)
        state = {"server": _capture_server(caps, server),
                 "acks": caps.ack_images}
        return cls._detached("run", loop.now, state, events, rekicks)

    @classmethod
    def capture_topology(cls, loop, topo) -> "FederationSnapshot":
        if topo.failovers:
            raise NotImplementedError(
                "cannot snapshot a failed-over root: the promoted "
                "transport's pre-failover ledger is gone")
        caps = _Capture()
        events, rekicks, n_credit = [], [], {}
        for lf in topo.leaves.values():
            _walk_server_legs(caps, lf.server, events, rekicks)
            _walk_server_timers(lf.server, events)
        _walk_topology_legs(caps, topo, events, rekicks, n_credit)
        servers = {lid: _capture_server(caps, lf.server)
                   for lid, lf in topo.leaves.items()}
        first_tr = next(iter(topo.leaves.values())).server.transport
        worker_reg = first_tr._ack_registry
        state = {
            "version": topo.version,
            "weights": topo.weights,
            "done": topo.done,
            "total_up": topo.total_up_bytes,
            "total_down": topo.total_down_bytes,
            "history": list(topo.history),
            "pending": dict(topo._pending),
            "failover_dispatches": list(topo.failover_dispatches),
            # root-carried optimizer moments (prev anchor re-derived, as
            # in _capture_server)
            "server_opt": (topo.server_opt.capture()
                           if topo.server_opt is not None else None),
            "leaves": {lid: {
                "dead": lf.dead, "started": lf.started,
                "agg_since_push": lf.agg_since_push,
                "n_data_since_push": (lf.n_data_since_push
                                      + n_credit.get(lid, 0)),
                "base_root_version": lf.base_root_version,
                "merged_base": lf.merged_base,
            } for lid, lf in topo.leaves.items()},
            "servers": servers,
            "transport": (None if topo.transport is None
                          else _capture_transport(caps, topo.transport)),
            "worker_acks": (None if worker_reg is None
                            else {wid: caps.ack_token(st)
                                  for wid, st in worker_reg._states.items()}),
            "server_acks": (None if topo._server_acks is None
                            else {lid: caps.ack_token(st)
                                  for lid, st
                                  in topo._server_acks._states.items()}),
            "acks": caps.ack_images,
        }
        return cls._detached("topology", loop.now, state, events, rekicks)

    # --- restore ---
    def _on(self, device: torch.device) -> "FederationSnapshot":
        """A copy of this snapshot with every tensor on ``device``, and
        every ``Sharded`` piece (row buffer, moments, link vectors, ack
        images, pinned payloads) on its own mesh device."""
        state, events, rekicks = _copy_graph(
            (self.state, self.events, self.rekicks), _to_device(device),
            place=True)
        return FederationSnapshot(self.kind, self.clock, state, events,
                                  rekicks)

    def restore_run(self, loop, server) -> None:
        """Restore into a FRESHLY BUILT, not-yet-started federation
        constructed with the same arguments as the captured one."""
        if self.kind != "run":
            raise ValueError(f"a {self.kind!r} snapshot restored as a run")
        snap = self._on(server._flat.device)
        ack_states = _build_ack_states(snap.state["acks"])
        _restore_server(server, snap.state["server"], ack_states)
        loop.now = snap.clock
        snap._replay(loop, {server.name: server}, None)
        snap._rekick({server.name: server}, None)

    def restore_topology(self, loop, topo) -> None:
        if self.kind != "topology":
            raise ValueError(f"a {self.kind!r} snapshot restored as a "
                             "topology")
        servers = {lid: lf.server for lid, lf in topo.leaves.items()}
        snap = self._on(next(iter(servers.values()))._flat.device)
        state = snap.state
        ack_states = _build_ack_states(state["acks"])
        # shared registries first: their states must BE the ones the
        # links get wired to below
        first_tr = next(iter(topo.leaves.values())).server.transport
        if first_tr._ack_registry is not None \
                and state["worker_acks"] is not None:
            first_tr._ack_registry._states = {
                wid: ack_states[tok]
                for wid, tok in state["worker_acks"].items()}
        if topo._server_acks is not None \
                and state["server_acks"] is not None:
            topo._server_acks._states = {
                lid: ack_states[tok]
                for lid, tok in state["server_acks"].items()}
        for lid, simg in state["servers"].items():
            _restore_server(servers[lid], simg, ack_states)
        if topo.transport is not None:
            _restore_transport(topo.transport, state["transport"],
                               ack_states, None)
        topo.version = state["version"]
        topo.weights = state["weights"]
        topo.done = state["done"]
        topo.total_up_bytes = state["total_up"]
        topo.total_down_bytes = state["total_down"]
        topo.history = list(state["history"])
        topo._pending = dict(state["pending"])
        topo.failover_dispatches = list(state["failover_dispatches"])
        if state["server_opt"] is not None and topo.server_opt is not None:
            topo.server_opt.restore(state["server_opt"])
        for lid, li in state["leaves"].items():
            lf = topo.leaves[lid]
            lf.dead = li["dead"]
            lf.started = li["started"]
            lf.agg_since_push = li["agg_since_push"]
            lf.n_data_since_push = li["n_data_since_push"]
            lf.base_root_version = li["base_root_version"]
            lf.merged_base = li["merged_base"]
            if topo.transport is not None:
                lf.link = topo.transport._links.get(lid, lf.link)
            # in-flight markers re-established by resume_push/resume_fan
            lf.push_inflight = lf.fan_inflight = None
            lf.push_rec = lf.fan_rec = None
            lf.done_settling = None
        loop.now = snap.clock
        snap._replay(loop, servers, topo)
        snap._rekick(servers, topo)

    def _replay(self, loop, servers: dict, topo) -> None:
        """Re-create every pending event in original (time, seq) order on
        the fresh loop; each resume helper consumes exactly one sequence
        number, so relative tie-break order is preserved."""
        for r in self.events:
            kind = r["kind"]
            if kind == "worker_leg":
                srv = servers[r["server"]]
                w = srv.workers[r["wid"]]
                link = srv.transport._links[r["wid"]]
                w.resume_conversation(srv.pointer, link, srv._on_response,
                                      r["rec"], r["t"])
            elif kind == "noop":
                servers[r["server"]].resume_noop_dispatch(r["t"])
            elif kind == "straggler":
                servers[r["server"]].resume_round_timeout(r["rid"], r["t"])
            elif kind == "push":
                topo.resume_push(topo.leaves[r["lid"]], r["rec"], r["t"])
            elif kind == "fan":
                topo.resume_fan(topo.leaves[r["lid"]], r["rec"], r["t"])
            elif kind == "settle":
                topo.resume_done_settled(topo.leaves[r["lid"]], r["t"])
            else:
                raise ValueError(f"unknown event record kind {kind!r}")

    def _rekick(self, servers: dict, topo) -> None:
        """Re-dispatch the instructions whose lossy in-flight legs were
        cancelled-with-credit at capture."""
        for rk in self.rekicks:
            if rk[0] == "train":
                srv = servers[rk[1]]
                srv._send_train(rk[2], srv.version)
            elif rk[0] == "push":
                topo._start_push(topo.leaves[rk[1]])
            elif rk[0] == "fan":
                topo._fan_out(topo.leaves[rk[1]])
            else:
                raise ValueError(f"unknown rekick {rk[0]!r}")
