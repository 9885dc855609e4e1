"""Wire-aware transport layer: codec'd flat-buffer weight exchange (port of
``repro/core/transport.py``).

Every weight transfer between the aggregation server and a worker goes
through a :class:`Transport`: one codec per direction and a :class:`Link`
per worker.  Codecs work on the packed flat f32 vector of
``flatbuf.ParamBundle`` and every payload travels in a :class:`Payload`
carrying its exact ``wire_bytes``.

Codec table (n = logical parameter count, k = max(1, int(n * frac)),
kept = entries surviving the top-k threshold):

  ============== ============================== =================== ==================
  codec          uplink payload (base =         downlink payload    wire_bytes
                 fetched model, ``tx_base``)    (base = last-acked
                                                state)
  ============== ============================== =================== ==================
  raw            full weights at native dtypes  full weights        sum(leaf nbytes)
  delta          f32 delta (new - base)         f32 delta           4 * n
  int8           int8 delta + 1 f32 scale       same, vs acked base n + 4
  topk_ef        top-k delta w/ EF              same, vs acked base ceil(n/8) + 4*kept
  topk_ef+int8   top-k + int8 on kept values    same, vs acked base ceil(n/8) + 4
                                                                      + kept
  auto           per-link: whichever row above  per-link, same rule the chosen row's
                 minimises expected latency                         cost per dispatch
  ============== ============================== =================== ==================

The uplink compresses ``delta + residual`` (error feedback); the downlink
compresses ``model - acked_base`` alone, and its residual is the encode's
output, never re-added.  ``acked_base`` advances only when a fetch
completes; a cancelled fetch reverts the downlink residual through the
:class:`WorkerAckState` revert chain, and a cancelled uplink credits its
reconstruction back into the uplink residual.  Every payload names the
codec it was encoded with, and every decode reads the spec off the
payload.

Every top-k and int8 encode is one call of ``kernels/topk_quant.ef_encode``
on the parts of ``x = (new - base) + residual``: the threshold's select,
the scale, the kept count and the quantising sweep in one launch on the
card.  A quantised downlink encode also writes the model its receiver
will hold, ``base + q * scale``, from the same launch (``ef_encode``'s
``decoded`` output, the link's next ``tx_base``), so it needs no decode.
A quantised response waits encoded (``flatbuf.EncodedVec``, its base
pinned at arrival) where the merge is its only reader: for
``dequant_add_rows`` to decode a whole merge at once, or for async_delta's
delta merge, whose ``dequant_mix`` decodes and merges it in one launch.
Every other quantised decode runs ``dequant_add`` (B4).  ``int(kept)`` is
the one host sync of a top-k encode: the wire bytes need it.

``auto`` is a per-dispatch resolver (``core/autotune.py``), not a codec:
at every encode the link picks the concrete row minimising ``expected
bytes * retx_factor / bandwidth + encode_cost``.  A ``delta``/``int8``
dispatch folds a carried uplink residual into its delta and a ``raw`` one
parks it; each such seam keeps the pre-encode residual per payload, so a
cancelled dispatch restores it exactly.  With a fixed codec none of this
triggers.

Unreliable links.  With a :class:`LinkReliability` attached
(``runtime/faults.inject_link_reliability``), every transfer goes through
:func:`transmit`'s seeded lossy channel: each logical payload gets a
per-link sequence number, each copy independently drops or duplicates,
the receiver dedups by sequence number *before* anything touches decode
state, EF residuals or byte counters, and the sender re-sends the SAME
:class:`Payload` (never re-encoded) after an ack timeout with exponential
backoff, priced off the estimator's measured bandwidth.  Retransmits count
on ``Transport.total_retransmits``, never in the byte counters.  With no
reliability model :func:`transmit` is one scheduled delivery.

Links materialise on first contact, and ``Transport.lru_evict`` drops the
least recently used quiescent links above a bound (cohort runs).

Sharded substrate.  ``Transport(mesh=...)`` resolves the SAME mesh-aware
bundle the server uses (N padded to ``BLOCK * n_shards``), and every pack
that feeds a link is split onto the mesh (``Transport.pack``), so every
link vector (``tx_base``, ``acked_base``, both EF residuals, the delta
codecs' payloads, the ack chain's residuals and pinned bases) is a
``parallel.sharding.Sharded`` vector: one (N/D,) piece a device, as the
JAX package's links hold shard-local slices.  The codec runs on the
pieces: ``ef_encode``'s sharded form selects the (global) threshold over
the gathered sample and reduces the scale and the kept count across the
shards' partials, each shard's sweep and each decode (``dequant_add``)
runs on its own device (a downlink's inside its encode), and the merge's
decode lands each shard's pieces in that shard's rows.  The wire bytes are unchanged (``kept`` is the
global count), and a sharded run equals the unsharded one bit for bit.
The worker side gathers where it unpacks (``ParamBundle.unpack``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import topk_quant
from repro_torch.parallel import sharding as psh

from . import flatbuf

# a link vector: whole, or Sharded over the server mesh
Vec = Union[torch.Tensor, psh.Sharded]

# tie-guard: a kth-largest |x| of exactly 0 (e.g. an all-zero delta from a
# data-less worker) must select nothing, not everything
_THRESH_FLOOR = topk_quant.THRESH_FLOOR


@dataclass(frozen=True)
class CodecSpec:
    """Static description of one codec: which stages apply."""
    name: str
    delta: bool          # encodes (new - base) instead of absolute weights
    topk: bool           # top-k sparsification (adds the bitmap term)
    quantize: bool       # int8 payload values (adds one f32 scale)
    ef: bool             # error feedback: per-link residual memory


CODECS: Dict[str, CodecSpec] = {
    "raw": CodecSpec("raw", delta=False, topk=False, quantize=False, ef=False),
    "delta": CodecSpec("delta", delta=True, topk=False, quantize=False,
                       ef=False),
    "int8": CodecSpec("int8", delta=True, topk=False, quantize=True,
                      ef=False),
    "topk_ef": CodecSpec("topk_ef", delta=True, topk=True, quantize=False,
                         ef=True),
    "topk_ef+int8": CodecSpec("topk_ef+int8", delta=True, topk=True,
                              quantize=True, ef=True),
}

# the ``auto`` direction-level pseudo-spec: a transport configured auto
# provisions for the most stateful codec its tuner can resolve to (packed
# tx_base, downlink ack protocol, EF residuals).  Not in CODECS: no payload
# ever travels as "auto"
AUTO_SPEC = CodecSpec("auto", delta=True, topk=True, quantize=True, ef=True)


@dataclass(slots=True)
class Payload:
    """Envelope for one wire transfer: codec-specific device data plus the
    exact number of bytes the transfer costs on the link."""
    codec: str
    wire_bytes: int
    data: object


def bitmap_bytes(n_params: int) -> int:
    return (n_params + 7) // 8


def topk_k(n_params: int, frac: float) -> int:
    return max(1, int(n_params * frac))


def expected_codec_bytes(spec: CodecSpec, n_params: int, raw_bytes: int,
                         frac: float) -> int:
    """Steady-state per-transfer bytes of one codec from its spec (top-k
    codecs: assumes exactly k survivors)."""
    if not spec.delta:
        return raw_bytes
    if spec.topk:
        k = topk_k(n_params, frac)
        itemsize = 1 if spec.quantize else 4
        return (bitmap_bytes(n_params) + (4 if spec.quantize else 0)
                + k * itemsize)
    if spec.quantize:
        return n_params + 4
    return 4 * n_params


# exact top-k up to this many params; above it the threshold comes from a
# deterministic strided sample (the DGC trick): the kept count lands within
# sampling error of k, the wire bytes count what actually survived, and
# error feedback recovers what a slightly high threshold dropped
_SAMPLE_CAP = topk_quant.SAMPLE_CAP


def topk_threshold(x: torch.Tensor, k: int, n_params: int) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates (exact for
    small vectors, sampled above _SAMPLE_CAP), floored at _THRESH_FLOOR."""
    return topk_quant.topk_threshold(x, k, n_params)


def _dequant(q, scale: torch.Tensor):
    """``q * scale`` in f32 (a ``Sharded`` q piece by piece, the scale
    copied to each piece's device)."""
    if isinstance(q, psh.Sharded):
        return psh.Sharded([_dequant(p, scale.to(p.device))
                            for p in q.shards], q.mesh)
    return q.to(torch.float32) * scale


def _decoded_kw(decoded) -> dict:
    """``ef_encode``'s decoded output as a keyword, only where one is
    given (an encode's keywords stay those of its plain version)."""
    return {} if decoded is None else {"decoded": decoded}


def _ef_encode_parts(a, b, c, *, n_params: int, frac: float,
                     quantize: bool, decoded=None):
    """EF top-k(+int8) encode of ``x = (a - b) + c``: ``(data, residual,
    wire_bytes)``, ``data`` being (q, scale) or the sparsified vector;
    ``decoded`` (quantise only) receives ``b + q * scale``."""
    out, resid, _, scale, kept = topk_quant.ef_encode(
        a, b, c, k=topk_k(n_params, frac), n_params=n_params,
        quantize=quantize, **_decoded_kw(decoded))
    kept = int(kept)
    if quantize:
        return (out, scale), resid, bitmap_bytes(n_params) + 4 + kept
    return out, resid, bitmap_bytes(n_params) + 4 * kept


def ef_topk_encode(x: torch.Tensor, *, n_params: int, frac: float,
                   quantize: bool):
    """Flat-vector EF top-k(+int8) encode of ``x`` (= delta + residual).
    Returns ``(data, recon, residual, wire_bytes)``: ``data`` travels
    ((q, scale) or the dense sparsified vector), ``recon`` is what the
    receiver reconstructs, ``residual`` the new error-feedback memory."""
    data, resid, wire = _ef_encode_parts(x, None, None, n_params=n_params,
                                         frac=frac, quantize=quantize)
    recon = _dequant(*data) if quantize else data
    return data, recon, resid, wire


class WorkerAckState:
    """One worker's downlink ack state: the last flat buffer any server
    knows the worker holds, plus the worker's downlink EF residual.

    ``_entries`` is the revert chain: one ``[residual-before-encode,
    residual-this-encode-wrote]`` record per in-flight encode, in encode
    order, so any interleaving of cancels and completions leaves the
    residual at the deficit of the dispatch the worker actually holds."""

    __slots__ = ("acked_base", "down_residual", "_entries")

    def __init__(self):
        self.acked_base: Optional[Vec] = None
        self.down_residual: Optional[Vec] = None
        self._entries: list = []

    def push(self) -> list:
        e = [self.down_residual, None]    # [res_before, resid_self]
        self._entries.append(e)
        return e

    def _index(self, entry) -> int:
        for i, e in enumerate(self._entries):
            if e is entry:
                return i
        return -1

    def complete(self, entry) -> None:
        """``entry``'s dispatch was delivered: older in-flight encodes
        revert to the deficit it established, and, unless a newer encode
        is still in flight, so does the live residual."""
        i = self._index(entry)
        if i < 0:
            return
        for e in self._entries[:i]:
            e[0] = entry[1]
        newest = i == len(self._entries) - 1
        self._entries.pop(i)
        if newest:
            self.down_residual = entry[1]

    def cancel(self, entry) -> None:
        """``entry``'s dispatch was never delivered: unlink it from the
        revert chain (the newest entry reverts the live residual)."""
        i = self._index(entry)
        if i < 0:
            return
        self._entries.pop(i)
        if i == len(self._entries):              # was the newest encode
            self.down_residual = entry[0]
        else:
            self._entries[i][0] = entry[0]


class WorkerAckRegistry:
    """Shared per-worker ack state: hand ONE registry to several servers'
    transports and their links to the same worker share one
    ``acked_base``."""

    def __init__(self):
        self._states: Dict[str, WorkerAckState] = {}

    def state(self, worker_id: str) -> WorkerAckState:
        st = self._states.get(worker_id)
        if st is None:
            st = self._states[worker_id] = WorkerAckState()
        return st


@dataclass(frozen=True)
class LinkReliability:
    """Seeded per-link loss model + retransmit policy.

    Each transmitted copy of a payload independently never arrives with
    probability ``drop_p`` and is delivered twice (the duplicate arriving
    at ``dup_delay * t_tx``) with probability ``dup_p``.  The sender
    retransmits the SAME payload after ``timeout_mult`` times the
    estimated one-way time, backing off by ``backoff`` per attempt, up to
    ``max_attempts`` copies.  Every draw comes from a per-(link, seed)
    ``numpy.random.RandomState``, the JAX package's generator, so a
    (topology, schedule, seed) triple replays its draws exactly."""
    drop_p: float = 0.0
    dup_p: float = 0.0
    seed: int = 0
    timeout_mult: float = 3.0
    backoff: float = 2.0
    max_attempts: int = 64
    dup_delay: float = 2.0


def _per_dir() -> Dict[str, int]:
    return {"up": 0, "down": 0}


@dataclass
class TransportAudit:
    """Delivery ledger of one transport's links, written only by
    :func:`transmit` (plus the fetch log receivers note at fetch time):
    what ``runtime/faults.audit_chaos_run`` closes the books against.

    ``sent_bytes[dir]`` counts original sends only (attempt 0);
    retransmitted copies land in ``retx_count``/``retx_bytes``; a
    deduplicated arrival lands in ``dup_count`` and nowhere else."""
    sent_bytes: Dict[str, int] = field(default_factory=_per_dir)
    sent_count: Dict[str, int] = field(default_factory=_per_dir)
    delivered_bytes: Dict[str, int] = field(default_factory=_per_dir)
    delivered_count: Dict[str, int] = field(default_factory=_per_dir)
    dup_count: Dict[str, int] = field(default_factory=_per_dir)
    retx_count: int = 0
    retx_bytes: int = 0
    # receiver-side fetch log: worker/leaf id -> model versions fetched,
    # in fetch-completion order
    fetch_versions: Dict[str, List[int]] = field(default_factory=dict)

    def note_sent(self, direction: str, nbytes: int, retransmit: bool):
        if retransmit:
            self.retx_count += 1
            self.retx_bytes += nbytes
        else:
            self.sent_bytes[direction] += nbytes
            self.sent_count[direction] += 1

    def note_delivered(self, direction: str, nbytes: int):
        self.delivered_bytes[direction] += nbytes
        self.delivered_count[direction] += 1

    def note_dup(self, direction: str):
        self.dup_count[direction] += 1

    def note_fetch(self, worker_id: str, version: int):
        self.fetch_versions.setdefault(worker_id, []).append(version)


class _Channel:
    """Per-link lossy-channel state: the seeded RNG, the per-payload
    sequence counter, and the receiver's delivered set (never pruned, so
    arbitrarily late duplicates still dedup)."""

    __slots__ = ("rng", "_seq", "delivered")

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed & 0xFFFFFFFF)
        self._seq = 0
        self.delivered: set = set()

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq


def _booked(aud: TransportAudit, direction: str, nbytes: int, deliver):
    def _deliver_booked():
        aud.note_delivered(direction, nbytes)
        deliver()
    return _deliver_booked


def transmit(loop, link: "Link", payload: Payload, t_tx: float, deliver,
             direction: str = "up"):
    """Send ``payload`` over ``link``; ``deliver`` runs exactly once, when
    the first copy arrives.

    With no reliability model this is ``loop.schedule(t_tx, deliver)``
    (booked on the transport's audit when it has one) and returns the
    event.  With one, the payload rides the lossy channel: dropped copies
    trigger an ack-timeout retransmit of the SAME payload with
    exponential backoff, and duplicate or late copies are dropped by the
    receiver's sequence dedup before they reach ``deliver``.  Returns
    None on that path."""
    rel = link.reliability
    aud = link.t.audit
    if rel is None:
        if aud is None:
            return loop.schedule(t_tx, deliver)
        aud.note_sent(direction, payload.wire_bytes, False)
        return loop.schedule(t_tx, _booked(aud, direction,
                                           payload.wire_bytes, deliver))
    t = link.t
    ch = link.channel()
    seq = ch.next_seq()
    # the pending ack-timeout event: the first delivery cancels it
    timer = [None]

    def _arrive():
        if seq in ch.delivered:          # duplicate or late retransmit:
            if aud is not None:          # dropped before ANY codec state
                aud.note_dup(direction)
            return
        ch.delivered.add(seq)            # doubles as the (instant) ack
        if timer[0] is not None:
            loop.cancel(timer[0])
            timer[0] = None
        if aud is not None:
            aud.note_delivered(direction, payload.wire_bytes)
        deliver()

    def _send(attempt: int):
        if aud is not None:
            aud.note_sent(direction, payload.wire_bytes, attempt > 0)
        if attempt > 0:
            t.total_retransmits += 1
        dropped = ch.rng.random_sample() < rel.drop_p
        duped = ch.rng.random_sample() < rel.dup_p
        if not dropped:
            loop.schedule(t_tx, _arrive)
            if duped:                    # network-level duplicate, late
                loop.schedule(rel.dup_delay * t_tx, _arrive)
        if attempt + 1 < rel.max_attempts:
            timer[0] = loop.schedule(
                link.rto(payload.wire_bytes, t_tx, attempt), _check, attempt)

    def _check(attempt: int):
        timer[0] = None
        if seq in ch.delivered or t.closed:   # acked, or the sender died
            return
        _send(attempt + 1)

    _send(0)
    return None


def resume_transmit(loop, link: "Link", payload: Payload, t_abs: float,
                    deliver, direction: str = "up"):
    """Re-create a reliable-path delivery event whose send was already
    booked, at its absolute deadline ``t_abs``: the audit (if any) books
    only the delivery."""
    aud = link.t.audit
    if link.reliability is None and aud is not None:
        deliver = _booked(aud, direction, payload.wire_bytes, deliver)
    return loop.schedule_abs(t_abs, deliver)


# sentinel: "no per-link override, inherit the transport's reliability"
_REL_INHERIT = object()


class Link:
    """One server<->worker channel: per-link codec state.

    ``tx_base`` is the packed model the worker fetched on the latest
    dispatch (the base every uplink delta encodes against and decodes
    onto); ``acked_base`` is the last flat buffer the server knows the
    worker holds (the base every downlink delta encodes against).  Each
    direction carries its own error-feedback residual.  Links never write
    a vector they share (``tx_base``, ``acked_base``, residuals): every
    codec stage returns new tensors."""

    __slots__ = ("t", "worker_id", "tx_base", "residual", "_ack",
                 "_pending_down", "_up_restore", "_reliability", "_chan",
                 "__dict__", "__weakref__")

    def __init__(self, transport: "Transport",
                 ack: Optional[WorkerAckState] = None,
                 worker_id: str = ""):
        self.t = transport
        self.worker_id = worker_id
        self.tx_base: Optional[Vec] = None   # packed dispatch base
        self.residual: Optional[Vec] = None  # uplink EF (topk_ef*)
        self._ack = ack if ack is not None else WorkerAckState()
        # in-flight downlink awaiting ack:
        # (payload, revert-chain entry or None, pinned encode base or None)
        self._pending_down: Optional[tuple] = None
        # auto-mode codec seam: (payload, pre-encode residual) of the last
        # uplink encode that folded carried EF mass, so a cancel restores
        # exactly what the seam consumed
        self._up_restore: Optional[tuple] = None
        self._reliability = _REL_INHERIT   # per-link override (loopbacks)
        self._chan: Optional[_Channel] = None

    # --- lossy-channel state ---
    @property
    def reliability(self) -> Optional[LinkReliability]:
        r = self._reliability
        return self.t.reliability if r is _REL_INHERIT else r

    @reliability.setter
    def reliability(self, value: Optional[LinkReliability]):
        self._reliability = value

    def channel(self) -> _Channel:
        ch = self._chan
        if ch is None:
            # crc32, not hash(): per-process hash randomisation would
            # break the seeded replay
            mix = (zlib.crc32(self.worker_id.encode())
                   ^ (self.reliability.seed * 2654435761)) & 0xFFFFFFFF
            ch = self._chan = _Channel(mix)
        return ch

    def rto(self, wire_bytes: int, t_tx: float, attempt: int) -> float:
        """Retransmit timeout of copy ``attempt``: ``timeout_mult`` times
        the estimated one-way time (the estimator's measured bandwidth
        when one is bound, the actual transmit time otherwise, whichever
        is longer), with exponential backoff."""
        rel = self.reliability
        base = t_tx
        est = self.t.rel_estimator
        if est is not None and self.worker_id:
            bw = est.bandwidth(self.worker_id)
            if bw:
                base = wire_bytes / bw
        return rel.timeout_mult * max(base, t_tx) * rel.backoff ** attempt

    @property
    def acked_base(self) -> Optional[Vec]:
        return self._ack.acked_base

    @property
    def down_residual(self) -> Optional[Vec]:
        return self._ack.down_residual

    # --- shared flat-delta codec stages ---
    def _codec_encode(self, new: Vec, base: Vec, residual,
                      spec: CodecSpec, frac: Optional[float] = None,
                      decoded=None) -> Tuple[Payload, object]:
        """Encode the packed flat delta ``(new - base) + residual``
        through ``spec`` at sparsity ``frac`` (the transport's when None);
        returns ``(payload, new_residual)``.  A carried residual folds in
        for every delta codec; for a non-EF spec that happens only at an
        auto codec seam, and the caller then clears the residual.  A
        quantised spec writes ``base + recon`` into ``decoded`` where it is
        given (``ef_encode``'s decoded output)."""
        t = self.t
        n = t.bundle.n_params
        if frac is None:
            frac = t.frac
        if spec.topk:
            data, resid, wire = _ef_encode_parts(
                new, base, residual, n_params=n, frac=frac,
                quantize=spec.quantize, decoded=decoded)
            return Payload(spec.name, wire, data), \
                (resid if spec.ef else residual)
        if spec.quantize:                        # int8: whole delta
            q, _, _, scale, _ = topk_quant.ef_encode(
                new, base, residual, k=None, n_params=n, quantize=True,
                **_decoded_kw(decoded))
            return Payload(spec.name, n + 4, (q, scale)), residual
        x = new - base
        if residual is not None:
            x = x + residual
        return Payload(spec.name, 4 * n, x), residual  # dense f32

    def _codec_apply(self, data, spec: CodecSpec,
                     base: Vec) -> Vec:
        """``base + recon(delta)``: the fused dequantise + delta-apply."""
        if spec.quantize:
            q, scale = data
            return topk_quant.dequant_add(q, scale, base)
        return base + data

    # --- downlink: server -> worker ---
    @property
    def needs_down_ack(self) -> bool:
        """True when the downlink codec is stateful (delta vs acked base),
        so fetch completion must be signalled explicitly."""
        return self.t.spec_down.delta

    def encode_down(self, weights_tree) -> Payload:
        with tracing.span("fl.encode_down", worker=self.worker_id):
            return self._encode_down(weights_tree)

    def _encode_down(self, weights_tree) -> Payload:
        t = self.t
        sd, frac = t.resolve_down(self)
        if not sd.delta:
            if t.tracks_tx_base:
                # remember the packed base so the uplink delta decodes
                self.tx_base = t._pack_down(weights_tree)
            payload = Payload("raw", t.raw_bytes, weights_tree)
            if t.auto_down:
                # an auto-resolved raw dispatch still rides the ack
                # machinery: its fetch-complete ack establishes the base
                # later delta dispatches encode against
                self._pending_down = (payload, None, None)
            return payload
        vec = t._pack_down(weights_tree)
        if self.acked_base is None:
            # first dispatch: the worker holds no base yet -> raw fallback
            self.tx_base = vec
            payload = Payload("raw", t.raw_bytes, weights_tree)
            self._pending_down = (payload, None, None)
            return payload
        # the delta vs the worker's ACTUAL (acked) state already re-carries
        # the mass past dispatches dropped, so no residual is added on top;
        # EF codecs still emit the residual OUTPUT (the worker's deficit)
        base = self.acked_base
        entry = self._ack.push()             # joins the revert chain
        # the worker-visible model after this fetch, the uplink base: a
        # quantised encode writes it from its own launch
        dec = None
        if sd.quantize:
            dec = base.empty_like() if isinstance(base, psh.Sharded) \
                else torch.empty_like(base)
        payload, new_res = self._codec_encode(vec, base, None, sd, frac,
                                              decoded=dec)
        self._ack.down_residual = entry[1] = new_res
        self.tx_base = dec if sd.quantize else \
            self._codec_apply(payload.data, sd, base)
        # pin the encode-time base: a peer may advance a shared ack first
        self._pending_down = (payload, entry, base)
        return payload

    def decode_down_vec(self, payload: Payload) -> Vec:
        """Payload -> packed flat f32 vector of the dispatched model,
        reconstructed against the base it was encoded from."""
        if payload.codec == "raw":
            return self.t._pack_down(payload.data)
        base = self.acked_base
        if (self._pending_down is not None
                and self._pending_down[0] is payload
                and self._pending_down[2] is not None):
            base = self._pending_down[2]
        return self._codec_apply(payload.data, CODECS[payload.codec], base)

    def decode_down(self, payload: Payload):
        """Payload -> weight dict (no ack bookkeeping)."""
        if payload.codec == "raw":
            return payload.data
        return self.t.bundle.unpack(self.decode_down_vec(payload))

    def ack_down(self, payload: Payload, vec: Vec) -> None:
        """Advance the last-acked state to ``vec`` at fetch completion.
        Only the pending payload may ack (a raw payload with nothing
        pending may too: re-acking a full model is exact)."""
        entry = None
        if self._pending_down is not None:
            if self._pending_down[0] is not payload:
                return               # stale fetch: not the pending dispatch
            entry = self._pending_down[1]
        elif payload.codec != "raw":
            return                   # delta payload already acked/cancelled
        self._ack.acked_base = vec
        self._pending_down = None
        if entry is not None:
            self._ack.complete(entry)

    def complete_fetch(self, payload: Payload):
        """Worker-side fetch completion: decode against the acked base,
        advance the ack, return the weight dict to train from (for the
        pending dispatch, the reconstruction computed at encode time)."""
        pending = (self._pending_down is not None
                   and self._pending_down[0] is payload)
        vec = self.tx_base if pending else self.decode_down_vec(payload)
        self.ack_down(payload, vec)
        if payload.codec == "raw":
            return payload.data
        return self.t.bundle.unpack(vec)

    def restore_downlink(self, payload: Payload) -> None:
        """Roll back a never-delivered downlink: the ack has not advanced,
        so the downlink EF residual reverts to its pre-encode value."""
        if self._pending_down is None or self._pending_down[0] is not payload:
            return
        _, entry, _base = self._pending_down
        self._pending_down = None
        if entry is not None:
            self._ack.cancel(entry)

    # --- uplink: worker -> server (codec'd response) ---
    def upfront_up_bytes(self) -> Optional[int]:
        """Exact uplink cost known before training, or None when it is
        data-dependent (top-k codecs; auto, whose codec is resolved at
        encode time)."""
        if self.t.spec_up.topk:
            return None
        return self.t.expected_up_bytes()

    def encode_up(self, new_tree) -> Payload:
        with tracing.span("fl.encode_up", worker=self.worker_id):
            return self._encode_up(new_tree)

    def _encode_up(self, new_tree) -> Payload:
        t = self.t
        spec, frac = t.resolve_up(self)
        if not spec.delta:                       # raw: ship the dict as-is
            if t.auto_up:
                # raw cannot carry EF mass: the residual is parked for the
                # next compressed dispatch (nothing consumed)
                self._up_restore = None
            return Payload(spec.name, t.raw_bytes, new_tree)
        vec = t.pack(new_tree)
        prev_res = self.residual
        payload, self.residual = self._codec_encode(
            vec, self.tx_base, prev_res, spec, frac)
        if t.auto_up:
            if not spec.ef and prev_res is not None:
                # auto codec seam: the carried residual was folded into
                # this exact/quantised delta, so the memory ends here;
                # keep it so a cancelled dispatch restores the mass
                self._up_restore = (payload, prev_res)
                self.residual = None
            else:
                self._up_restore = None
        return payload

    def decode_up_vec(self, payload: Payload) -> Vec:
        """Payload -> packed flat f32 vector of the worker's new absolute
        weights (lands in the server's (W, N) row buffer)."""
        spec = CODECS[payload.codec]
        with tracing.span("fl.decode_up", worker=self.worker_id):
            if not spec.delta:
                return self.t.pack(payload.data)
            return self._codec_apply(payload.data, spec, self.tx_base)

    def up_vec_deferred(self, payload: Payload):
        """``decode_up_vec`` for a response whose only reader is the merge:
        a quantised delta stays encoded as ``flatbuf.EncodedVec``, its base
        pinned now (a later dispatch moves ``tx_base``), for
        ``merge_rows`` to decode with the rest of its merge (inside the
        merge's span, not a decode's).  Anything else decodes now."""
        spec = CODECS[payload.codec]
        if spec.delta and spec.quantize:
            q, scale = payload.data
            return flatbuf.EncodedVec(q, scale, self.tx_base)
        return self.decode_up_vec(payload)

    def decode_up_tree(self, payload: Payload):
        """Payload -> weight dict."""
        if not CODECS[payload.codec].delta:
            return payload.data
        return self.t.bundle.unpack(self.decode_up_vec(payload))

    def restore_uplink(self, payload: Payload) -> None:
        """Credit a never-applied uplink's reconstruction back into the EF
        residual (encode debited it assuming delivery).  The spec is the
        payload's; a cancelled non-EF dispatch that folded carried residual
        at an auto codec seam restores the pre-encode residual instead."""
        spec = CODECS[payload.codec]
        if self._up_restore is not None and self._up_restore[0] is payload:
            restore = self._up_restore[1]
            self._up_restore = None
            if not spec.ef:
                self.residual = restore if self.residual is None \
                    else self.residual + restore
                return
        if not spec.ef:
            return
        data = payload.data
        recon = _dequant(*data) if spec.quantize else data
        self.residual = recon if self.residual is None \
            else self.residual + recon


class Transport:
    """Codec registry instance + per-worker links for one server.

    ``codec`` names the uplink codec, ``down_codec`` the downlink one
    (None = the same both ways; ``"raw"`` = uplink-only compression;
    ``"auto"`` = the per-link tuner, with ``auto_policy`` its knobs).
    ``raw_bytes`` defaults to the template's native byte size.
    ``ack_registry`` shares per-worker downlink ack state across servers.
    """

    def __init__(self, template, codec: str = "raw", *,
                 down_codec: Optional[str] = None, frac: float = 0.1,
                 raw_bytes: Optional[int] = None, mesh=None,
                 ack_registry: Optional[WorkerAckRegistry] = None,
                 auto_policy=None):
        if down_codec is None:
            down_codec = codec
        for c in (codec, down_codec):
            if c not in CODECS and c != AUTO_SPEC.name:
                raise ValueError(f"unknown codec {c!r}; have "
                                 f"{sorted(CODECS) + [AUTO_SPEC.name]}")
        self.auto_up = codec == AUTO_SPEC.name
        self.auto_down = down_codec == AUTO_SPEC.name
        self.spec_up = AUTO_SPEC if self.auto_up else CODECS[codec]
        self.spec_down = AUTO_SPEC if self.auto_down else CODECS[down_codec]
        self.frac = float(frac)
        # the server's (mesh-aware) bundle; with a mesh every link vector
        # is Sharded over it (pack)
        self.mesh = mesh
        self.bundle = flatbuf.bundle_for(template, mesh)
        self.raw_bytes = (int(raw_bytes) if raw_bytes is not None
                          else self.bundle.raw_bytes)
        self._ack_registry = ack_registry
        # auto mode: the per-link codec/frac resolver; whoever owns the
        # estimator binds its bandwidth sources
        if self.auto_up or self.auto_down:
            from .autotune import AutoTuner
            self.tuner: Optional[object] = AutoTuner(
                self.bundle.n_params, self.raw_bytes, auto_policy)
        else:
            self.tuner = None
        # access-ordered (link() re-inserts on a hit), so iteration order
        # is least-recently-used order, what lru_evict walks
        self._links: Dict[str, Link] = {}
        self.total_link_evictions = 0
        # lossy-channel model (None = perfect wire, the default);
        # runtime/faults injects these per tier
        self.reliability: Optional[LinkReliability] = None
        self.rel_estimator = None     # TimeEstimator pricing retransmit RTOs
        self.total_retransmits = 0
        self.audit: Optional[TransportAudit] = None
        # a dead owner (a failed-over root) closes its transport: copies on
        # the wire still arrive, but retransmit timers stop re-sending
        self.closed = False
        # one packed copy of the current server model per dispatch round:
        # every selected worker's encode_down shares it (keyed on identity)
        self._down_tree = None
        self._down_vec: Optional[Vec] = None

    def pack(self, tree):
        """``tree`` packed as the links hold it: whole, or with a mesh
        ``Sharded`` over it (one (N/D,) piece a device)."""
        vec = self.bundle.pack(tree)
        return vec if self.mesh is None else psh.split(vec, self.mesh)

    def _pack_down(self, weights_tree):
        if self._down_tree is not weights_tree:
            self._down_vec = self.pack(weights_tree)
            self._down_tree = weights_tree
        return self._down_vec

    @property
    def codec(self) -> str:
        return self.spec_up.name

    @property
    def down_codec(self) -> str:
        return self.spec_down.name

    @property
    def flat_capable(self) -> bool:
        return self.bundle is not None

    @property
    def tracks_tx_base(self) -> bool:
        """True when links carry a packed dispatch base (either direction
        is a delta codec)."""
        return self.spec_up.delta or self.spec_down.delta

    # --- per-dispatch codec resolution (auto mode) ---
    def resolve_up(self, link: Link) -> Tuple[CodecSpec, float]:
        """The concrete (spec, frac) of this link's next uplink encode:
        the configured constants, or the tuner's per-link choice."""
        if not self.auto_up:
            return self.spec_up, self.frac
        name, frac = self.tuner.choose(link.worker_id, self._retx_factor())
        return CODECS[name], frac

    def resolve_down(self, link: Link) -> Tuple[CodecSpec, float]:
        if not self.auto_down:
            return self.spec_down, self.frac
        name, frac = self.tuner.choose(link.worker_id, self._retx_factor())
        return CODECS[name], frac

    def note_round(self, point) -> None:
        """HistoryPoint feedback after each round: advances the auto
        tuner's warmup/plateau schedule (a no-op with fixed codecs)."""
        if self.tuner is not None:
            self.tuner.note_round(point.accuracy)

    def link(self, worker_id: str) -> Link:
        l = self._links.get(worker_id)
        if l is None:
            ack = (self._ack_registry.state(worker_id)
                   if self._ack_registry is not None else None)
            l = self._links[worker_id] = Link(self, ack, worker_id)
        else:
            # move to the end: dict order is recency order for lru_evict
            del self._links[worker_id]
            self._links[worker_id] = l
        return l

    def lru_evict(self, keep=(), max_links: Optional[int] = None) -> int:
        """Evict least-recently-used QUIESCENT links until at most
        ``max_links`` remain; returns how many were dropped.  Links in
        ``keep`` (the server passes its outstanding, in-flight, windowed
        and held workers) and links with a pending downlink are never
        candidates.  A re-contacted link starts fresh: no acked base (a
        raw first-contact dispatch) and no uplink residual."""
        if max_links is None or len(self._links) <= max_links:
            return 0
        evicted = 0
        keep = set(keep)
        for wid in list(self._links):
            if len(self._links) <= max_links:
                break
            l = self._links[wid]
            if wid in keep or l._pending_down is not None:
                continue
            del self._links[wid]
            evicted += 1
        self.total_link_evictions += evicted
        return evicted

    # --- expected costs (selection time budgets / straggler timeouts) ---
    def _retx_factor(self) -> float:
        """Expected transmissions per delivered payload on a lossy link
        (geometric: 1/(1-drop_p)); 1.0 on a perfect wire."""
        rel = self.reliability
        if rel is None or rel.drop_p <= 0.0:
            return 1.0
        return 1.0 / max(1.0 - rel.drop_p, 1e-3)

    def _expected_bytes(self, spec: CodecSpec, auto: bool) -> int:
        frac = self.frac
        if auto:
            name, frac = self.tuner.steady_choice(self._retx_factor())
            spec = CODECS[name]
        return int(expected_codec_bytes(spec, self.bundle.n_params,
                                        self.raw_bytes, frac)
                   * self._retx_factor())

    def expected_down_bytes(self) -> int:
        """Per-dispatch downlink estimate from the down codec spec (first
        contact costs ``raw_bytes``); under auto, the tuner's current
        steady choice, so it varies from round to round."""
        return self._expected_bytes(self.spec_down, self.auto_down)

    def expected_up_bytes(self) -> int:
        """Per-response uplink estimate from the codec spec (top-k codecs:
        assumes exactly k survivors); auto as :meth:`expected_down_bytes`."""
        return self._expected_bytes(self.spec_up, self.auto_up)

    def expected_oneway_bytes(self) -> int:
        """Mean per-direction bytes of a round trip: what the selection
        policies plug into the eq-3.4 time budget."""
        return (self.expected_down_bytes() + self.expected_up_bytes()) // 2
