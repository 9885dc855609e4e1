"""FL worker (thesis §3.1.5/§3.3; port of ``repro/core/worker.py``): holds
a local model + data shard, obeys train instructions from its aggregation
server, responds with weights via the warehouse's one-time-ticket channel.

Numerics run for real (PyTorch on the setup's device); durations are
simulated from the same profile statistics the estimator sees, but with
the *true* per-worker speed.

Every send goes through ``transport.transmit`` with its direction and
link, so a lossy link (``LinkReliability``) drops, duplicates and
retransmits it; on a perfect wire each leg is one scheduled event.

Every in-flight train conversation keeps a phase record in ``_conv``
(fetch -> train -> send), holding exactly the inputs the pending event will
consume when it fires.  A checkpoint reads those records to serialize the
leg; :meth:`FLWorker.resume_conversation` re-creates the pending event
from one, bit-identically.  The records are pure bookkeeping: no
behaviour of the live run reads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch import tracing

from .estimator import WorkerProfile
from .events import EventLoop
from .transport import Link, Payload, resume_transmit, transmit
from .warehouse import DataWarehouse, Pointer


@dataclass
class TrainResult:
    worker_id: str
    weights_ticket: str
    base_version: int         # server version the worker trained from
    epochs: int
    n_batches: int
    t_train: float            # measured training time (simulated clock)
    t_up: float = 0.0         # measured uplink transmit time
    up_bytes: int = 0         # exact wire bytes of the encoded response


class FLWorker:
    __slots__ = ("worker_id", "address", "profile", "data", "train_fn",
                 "loop", "warehouse", "server_pointers", "_inflight",
                 "_fetching", "_conv", "busy", "_per_batch_time")

    def __init__(self, worker_id: str, *, profile: WorkerProfile,
                 data: Dict, train_fn: Callable, loop: EventLoop,
                 per_batch_time: Optional[float] = None):
        self.worker_id = worker_id
        self.address = f"worker://{worker_id}"
        self.profile = profile
        self.data = data               # {"x", "y"}: tensors on the device
        self.train_fn = train_fn       # (params, x, y, epochs) -> params
        self.loop = loop
        self.warehouse = DataWarehouse()
        self.server_pointers: List[Pointer] = []   # ACL (thesis §3.3.3 step 4)
        # in-flight uplink per server: (ticket, payload, link) from ticket
        # issue until delivery
        self._inflight: Dict[Pointer, tuple] = {}
        # in-flight downlink fetch per server: (payload, link) from dispatch
        # until the fetch-complete event
        self._fetching: Dict[Pointer, tuple] = {}
        # per-server conversation phase record (checkpoint bookkeeping)
        self._conv: Dict[Pointer, dict] = {}
        self.busy = False
        # ground-truth speed (may differ from the estimator's eq-3.4 guess)
        self._per_batch_time = per_batch_time if per_batch_time is not None \
            else 0.05 * 3.0 / max(profile.cpu_freq * profile.cpu_prop, 1e-9)

    # --- relationship API (thesis §3.3.1) ---
    def add_server(self, server_pointer: Pointer):
        self.server_pointers.append(server_pointer)

    def accepts(self, server_pointer: Pointer) -> bool:
        return server_pointer in self.server_pointers

    def remove_server(self, server_pointer: Pointer):
        """Revoke a server's ACL entry: in-progress instructions from it
        die silently at their next ``accepts`` check."""
        if server_pointer in self.server_pointers:
            self.server_pointers.remove(server_pointer)

    def cancel_inflight(self, server_pointer: Pointer) -> None:
        """Cancel this server's in-flight transfers (its round closed): an
        unfinished fetch is dropped without advancing the downlink ack; an
        in-transit uplink has its ticket revoked and its encoded mass
        credited back into the link's error-feedback residual."""
        fetch = self._fetching.pop(server_pointer, None)
        if fetch is not None:
            down, link = fetch
            rec = self._conv.get(server_pointer)
            if rec is not None and rec.get("down") is down:
                self._conv.pop(server_pointer)
            link.restore_downlink(down)
            self.busy = False
        entry = self._inflight.pop(server_pointer, None)
        if entry is not None:
            ticket, up, link = entry
            rec = self._conv.get(server_pointer)
            if rec is not None and rec.get("ticket") == ticket:
                self._conv.pop(server_pointer)
            self.warehouse.revoke_ticket(ticket)
            link.restore_uplink(up)

    def true_t_one(self) -> float:
        return self._per_batch_time * max(self.profile.n_batches, 0)

    def true_t_transmit(self, model_bytes: int) -> float:
        return model_bytes / max(self.profile.bandwidth, 1.0)

    # --- training API (thesis §3.3.3) ---
    def train_async(self, server_pointer: Pointer, down: Payload,
                    base_version: int, epochs: int, link: Link,
                    on_done: Callable[[TrainResult], None]):
        """Simulates one train instruction end to end: fetch (T_transmit
        over the downlink payload bytes), train (T_one * r), encode the
        response through the link's codec, and respond (T_transmit over
        the uplink payload bytes).  ``on_done`` fires on the event loop.

        Stateful (delta) downlinks, and every downlink of a lossy link,
        schedule an explicit fetch-complete event that decodes (and, when
        stateful, advances the ack).  On a perfect wire, codecs whose
        uplink size is known before training run the rest as one event;
        top-k codecs, auto and lossy links train first and send the
        response as its own leg."""
        if not self.accepts(server_pointer) or self.profile.failed:
            # a dispatch that never lands: un-debit the downlink EF state
            link.restore_downlink(down)
            return
        self.busy = True
        t_fetch = self.true_t_transmit(down.wire_bytes)
        if link.needs_down_ack or link.reliability is not None:
            # the channel must deliver before the worker can decode, and
            # the staged event is what transmit() retransmits against
            self._fetching[server_pointer] = (down, link)
            rec = {"phase": "fetch", "down": down,
                   "base_version": base_version, "epochs": epochs,
                   "ev": None}
            self._conv[server_pointer] = rec
            rec["ev"] = transmit(
                self.loop, link, down, t_fetch,
                lambda: self._fetch_done(server_pointer, down, base_version,
                                         epochs, link, on_done),
                direction="down")
            return
        weights = link.decode_down(down)
        self._after_fetch(server_pointer, weights, base_version, epochs,
                          link, on_done, t_fetch)

    def _fetch_done(self, server_pointer: Pointer, down: Payload,
                    base_version: int, epochs: int, link: Link, on_done):
        entry = self._fetching.get(server_pointer)
        if entry is None or entry[0] is not down:
            return      # this fetch was cancelled (round closed)
        self._fetching.pop(server_pointer)
        rec = self._conv.get(server_pointer)
        if rec is not None and rec.get("down") is down:
            self._conv.pop(server_pointer)
        if self.profile.failed:          # died mid-fetch: never received
            link.restore_downlink(down)
            self.busy = False
            return
        # stateless downlinks staged only for the lossy channel skip the
        # ack bookkeeping
        if link.needs_down_ack:
            weights = link.complete_fetch(down)
        else:
            weights = link.decode_down(down)
        self._after_fetch(server_pointer, weights, base_version, epochs,
                          link, on_done, 0.0)

    def _train(self, weights, epochs: int, base_version: int):
        if len(self.data["x"]):
            with tracing.span("fl.train", round=base_version,
                              worker=self.worker_id):
                return self.train_fn(weights, self.data["x"],
                                     self.data["y"], epochs)
        return weights              # no local data: echo (setup-3 zeros)

    def _after_fetch(self, server_pointer: Pointer, weights,
                     base_version: int, epochs: int, link: Link, on_done,
                     t_fetch: float):
        """Train + respond, scheduled ``t_fetch`` from now."""
        if link.t.audit is not None:
            # chaos ledger: this worker now holds this server version
            link.t.audit.note_fetch(self.worker_id, base_version)
        t_train = self.true_t_one() * epochs
        up_bytes = link.upfront_up_bytes()
        if up_bytes is not None and link.reliability is None:
            # one event for the rest, only on a perfect wire: a lossy
            # uplink needs the staged in-flight record to retransmit
            rec = {"phase": "train_fast", "weights": weights,
                   "base_version": base_version, "epochs": epochs,
                   "up_bytes": up_bytes, "t_train": t_train, "ev": None}
            self._conv[server_pointer] = rec
            self._schedule_finish(server_pointer, link, on_done, rec,
                                  t_fetch + t_train +
                                  self.true_t_transmit(up_bytes))
            return
        rec = {"phase": "train", "weights": weights,
               "base_version": base_version, "epochs": epochs,
               "t_train": t_train, "ev": None}
        self._conv[server_pointer] = rec
        self._schedule_train_send(server_pointer, link, on_done, rec,
                                  t_fetch + t_train)

    def _schedule_finish(self, server_pointer: Pointer, link: Link,
                         on_done, rec: dict, delay: float, *,
                         at_abs: Optional[float] = None):
        weights, epochs = rec["weights"], rec["epochs"]
        base_version, t_train = rec["base_version"], rec["t_train"]
        up_bytes = rec["up_bytes"]

        def _finish():
            if self._conv.get(server_pointer) is rec:
                self._conv.pop(server_pointer)
            # died mid-training, or the server dropped this worker
            if self.profile.failed or not self.accepts(server_pointer):
                self.busy = False
                return
            up = link.encode_up(self._train(weights, epochs, base_version))
            if up.wire_bytes != up_bytes:
                raise RuntimeError(f"uplink size {up.wire_bytes} != the "
                                   f"upfront {up_bytes}")
            ticket = self.warehouse.issue_ticket(self.warehouse.put(up))
            self.busy = False
            on_done(TrainResult(self.worker_id, ticket, base_version,
                                epochs, self.profile.n_batches, t_train,
                                t_up=self.true_t_transmit(up.wire_bytes),
                                up_bytes=up.wire_bytes))
        rec["ev"] = (self.loop.schedule_abs(at_abs, _finish)
                     if at_abs is not None
                     else self.loop.schedule(delay, _finish))

    def _schedule_train_send(self, server_pointer: Pointer, link: Link,
                             on_done, rec: dict, delay: float, *,
                             at_abs: Optional[float] = None):
        weights, epochs = rec["weights"], rec["epochs"]
        base_version, t_train = rec["base_version"], rec["t_train"]

        def _train_then_send():
            if self._conv.get(server_pointer) is rec:
                self._conv.pop(server_pointer)
            if self.profile.failed or not self.accepts(server_pointer):
                self.busy = False
                return
            up = link.encode_up(self._train(weights, epochs, base_version))
            ticket = self.warehouse.issue_ticket(self.warehouse.put(up))
            self._inflight[server_pointer] = (ticket, up, link)
            t_up = self.true_t_transmit(up.wire_bytes)
            srec = {"phase": "send", "ticket": ticket, "up": up,
                    "base_version": base_version, "epochs": epochs,
                    "t_train": t_train, "t_up": t_up, "ev": None}
            self._conv[server_pointer] = srec
            self._schedule_send(server_pointer, link, on_done, srec, t_up)
        rec["ev"] = (self.loop.schedule_abs(at_abs, _train_then_send)
                     if at_abs is not None
                     else self.loop.schedule(delay, _train_then_send))

    def _schedule_send(self, server_pointer: Pointer, link: Link, on_done,
                       rec: dict, delay: float, *, resumed: bool = False,
                       at_abs: Optional[float] = None):
        ticket, up = rec["ticket"], rec["up"]
        base_version, epochs = rec["base_version"], rec["epochs"]
        t_train, t_up = rec["t_train"], rec["t_up"]

        def _send():
            entry = self._inflight.get(server_pointer)
            if entry is None or entry[0] != ticket:
                # cancelled (round closed; ticket revoked, EF mass
                # restored); a newer dispatch may already own the slot
                if entry is None:
                    self.busy = False
                return
            self._inflight.pop(server_pointer)
            if self._conv.get(server_pointer) is rec:
                self._conv.pop(server_pointer)
            if self.profile.failed:      # died mid-transmit
                self.warehouse.revoke_ticket(ticket)
                link.restore_uplink(up)
                self.busy = False
                return
            self.busy = False
            on_done(TrainResult(self.worker_id, ticket, base_version,
                                epochs, self.profile.n_batches, t_train,
                                t_up=t_up, up_bytes=up.wire_bytes))
        if resumed:
            # the send was booked by the transmit() before the snapshot:
            # re-create only the delivery event
            rec["ev"] = self._sched_delivery(link, up, _send, at_abs, "up")
        else:
            rec["ev"] = transmit(self.loop, link, up, delay, _send,
                                 direction="up")

    # --- checkpoint/resume ---
    def _sched_delivery(self, link: Link, payload: Payload, deliver,
                        t_abs: float, direction: str):
        return resume_transmit(self.loop, link, payload, t_abs, deliver,
                               direction)

    def resume_conversation(self, server_pointer: Pointer, link: Link,
                            on_done, rec: dict, t_abs: float):
        """Re-create one snapshotted in-flight leg.  Consumes exactly one
        ``loop.schedule_abs`` call, so the restore's sorted (time, seq)
        replay keeps the original tie-break order, and the serialized
        absolute deadline is replayed exactly."""
        phase = rec["phase"]
        self.busy = True
        self._conv[server_pointer] = rec
        if phase == "fetch":
            down = rec["down"]
            self._fetching[server_pointer] = (down, link)
            rec["ev"] = self._sched_delivery(
                link, down,
                lambda: self._fetch_done(server_pointer, down,
                                         rec["base_version"],
                                         rec["epochs"], link, on_done),
                t_abs, "down")
        elif phase == "train_fast":
            self._schedule_finish(server_pointer, link, on_done, rec, 0.0,
                                  at_abs=t_abs)
        elif phase == "train":
            self._schedule_train_send(server_pointer, link, on_done, rec,
                                      0.0, at_abs=t_abs)
        elif phase == "send":
            self._inflight[server_pointer] = (rec["ticket"], rec["up"],
                                              link)
            self._schedule_send(server_pointer, link, on_done, rec, 0.0,
                                resumed=True, at_abs=t_abs)
        else:
            raise ValueError(f"unknown conversation phase: {phase!r}")
