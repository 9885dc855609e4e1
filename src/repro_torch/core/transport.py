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
  ============== ============================== =================== ==================

The uplink compresses ``delta + residual`` (error feedback); the downlink
compresses ``model - acked_base`` alone, and its residual is the encode's
output, never re-added.  ``acked_base`` advances only when a fetch
completes; a cancelled fetch reverts the downlink residual through the
:class:`WorkerAckState` revert chain, and a cancelled uplink credits its
reconstruction back into the uplink residual.  Every payload names the
codec it was encoded with, and every decode reads the spec off the
payload.

The quantised encode and every quantised decode run the fused kernels of
``kernels/topk_quant`` (``topk_quant_encode``, ``dequant_add``).  The
top-k threshold is a library call (``torch.topk`` / ``torch.sort``), as
it is in the JAX package.  ``int(kept)`` is the one host sync of an
encode: the wire bytes need it.

Not ported yet: the ``auto`` codec resolver and ``LinkReliability`` lossy
links (ROADMAP A5) and the ``mesh=`` sharded substrate (ROADMAP A11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import topk_quant

from . import flatbuf

# tie-guard: a kth-largest |x| of exactly 0 (e.g. an all-zero delta from a
# data-less worker) must select nothing, not everything
_THRESH_FLOOR = 1e-30


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
_SAMPLE_CAP = 1 << 17


def topk_threshold(x: torch.Tensor, k: int, n_params: int) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates (exact for
    small vectors, sampled above _SAMPLE_CAP), floored at _THRESH_FLOOR."""
    if n_params <= _SAMPLE_CAP:
        t = torch.topk(x.abs(), k).values[-1]
    else:
        P = int(x.shape[0])
        stride = max(1, P // _SAMPLE_CAP)
        m = (P + stride - 1) // stride
        ks = min(m, max(1, round(m * k / n_params)))
        t = x.abs()[::stride].sort().values[-ks]
    return torch.clamp_min(t, _THRESH_FLOOR)


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.abs().max(), 1e-12) / 127.0


def _kept_count(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.abs() >= thresh)


def _mask_encode(x: torch.Tensor, thresh: torch.Tensor):
    """Top-k sparsify without quantisation: (recon, residual)."""
    recon = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
    return recon, x - recon


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_topk_encode(x: torch.Tensor, *, n_params: int, frac: float,
                   quantize: bool):
    """Flat-vector EF top-k(+int8) encode of ``x`` (= delta + residual).
    Returns ``(data, recon, residual, wire_bytes)``: ``data`` travels
    ((q, scale) or the dense sparsified vector), ``recon`` is what the
    receiver reconstructs, ``residual`` the new error-feedback memory."""
    thresh = topk_threshold(x, topk_k(n_params, frac), n_params)
    kept = int(_kept_count(x, thresh))
    if quantize:
        scale = _int8_scale(x)
        q, resid = topk_quant.topk_quant_encode(x, thresh, scale)
        wire = bitmap_bytes(n_params) + 4 + kept
        return (q, scale), _dequant(q, scale), resid, wire
    recon, resid = _mask_encode(x, thresh)
    wire = bitmap_bytes(n_params) + 4 * kept
    return recon, recon, resid, wire


class WorkerAckState:
    """One worker's downlink ack state: the last flat buffer any server
    knows the worker holds, plus the worker's downlink EF residual.

    ``_entries`` is the revert chain: one ``[residual-before-encode,
    residual-this-encode-wrote]`` record per in-flight encode, in encode
    order, so any interleaving of cancels and completions leaves the
    residual at the deficit of the dispatch the worker actually holds."""

    __slots__ = ("acked_base", "down_residual", "_entries")

    def __init__(self):
        self.acked_base: Optional[torch.Tensor] = None
        self.down_residual: Optional[torch.Tensor] = None
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


class LinkReliability:
    """Seeded lossy links with retransmits: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "lossy links (LinkReliability) are not ported yet (ROADMAP A5)")


def transmit(loop, link: "Link", payload: Payload, t_tx: float, deliver,
             direction: str = "up"):
    """Send ``payload`` over ``link``: on a perfect wire, one delivery
    event ``t_tx`` from now.  Returns the event."""
    return loop.schedule(t_tx, deliver)


def resume_transmit(loop, link: "Link", payload: Payload, t_abs: float,
                    deliver, direction: str = "up"):
    """Re-create a delivery event at its absolute deadline ``t_abs``."""
    return loop.schedule_abs(t_abs, deliver)


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
                 "_pending_down", "__dict__", "__weakref__")

    def __init__(self, transport: "Transport",
                 ack: Optional[WorkerAckState] = None,
                 worker_id: str = ""):
        self.t = transport
        self.worker_id = worker_id
        self.tx_base: Optional[torch.Tensor] = None   # packed dispatch base
        self.residual: Optional[torch.Tensor] = None  # uplink EF (topk_ef*)
        self._ack = ack if ack is not None else WorkerAckState()
        # in-flight downlink awaiting ack:
        # (payload, revert-chain entry or None, pinned encode base or None)
        self._pending_down: Optional[tuple] = None

    @property
    def acked_base(self) -> Optional[torch.Tensor]:
        return self._ack.acked_base

    @property
    def down_residual(self) -> Optional[torch.Tensor]:
        return self._ack.down_residual

    # --- shared flat-delta codec stages ---
    def _codec_encode(self, delta: torch.Tensor, residual,
                      spec: CodecSpec) -> Tuple[Payload, object]:
        """Encode one packed flat delta through ``spec``; returns
        ``(payload, new_residual)``."""
        t = self.t
        n = t.bundle.n_params
        if spec.topk:
            x = delta if residual is None else delta + residual
            data, _, resid, wire = ef_topk_encode(
                x, n_params=n, frac=t.frac, quantize=spec.quantize)
            return Payload(spec.name, wire, data), \
                (resid if spec.ef else residual)
        x = delta if residual is None else delta + residual
        if spec.quantize:                        # int8: whole delta
            scale = _int8_scale(x)
            q, _ = topk_quant.topk_quant_encode(x, 0.0, scale)
            return Payload(spec.name, n + 4, (q, scale)), residual
        return Payload(spec.name, 4 * n, x), residual  # dense f32

    def _codec_apply(self, data, spec: CodecSpec,
                     base: torch.Tensor) -> torch.Tensor:
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
        t = self.t
        sd = t.spec_down
        if not sd.delta:
            if t.tracks_tx_base:
                # remember the packed base so the uplink delta decodes
                self.tx_base = t._pack_down(weights_tree)
            return Payload("raw", t.raw_bytes, weights_tree)
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
        payload, new_res = self._codec_encode(vec - base, None, sd)
        self._ack.down_residual = entry[1] = new_res
        # the worker-visible model after this fetch: the uplink base
        self.tx_base = self._codec_apply(payload.data, sd, base)
        # pin the encode-time base: a peer may advance a shared ack first
        self._pending_down = (payload, entry, base)
        return payload

    def decode_down_vec(self, payload: Payload) -> torch.Tensor:
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

    def ack_down(self, payload: Payload, vec: torch.Tensor) -> None:
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
        data-dependent (top-k codecs)."""
        if self.t.spec_up.topk:
            return None
        return self.t.expected_up_bytes()

    def encode_up(self, new_tree) -> Payload:
        spec = self.t.spec_up
        if not spec.delta:                       # raw: ship the dict as-is
            return Payload(spec.name, self.t.raw_bytes, new_tree)
        vec = self.t.bundle.pack(new_tree)
        payload, self.residual = self._codec_encode(
            vec - self.tx_base, self.residual, spec)
        return payload

    def decode_up_vec(self, payload: Payload) -> torch.Tensor:
        """Payload -> packed flat f32 vector of the worker's new absolute
        weights (lands in the server's (W, N) row buffer)."""
        spec = CODECS[payload.codec]
        if not spec.delta:
            return self.t.bundle.pack(payload.data)
        return self._codec_apply(payload.data, spec, self.tx_base)

    def decode_up_tree(self, payload: Payload):
        """Payload -> weight dict."""
        if not CODECS[payload.codec].delta:
            return payload.data
        return self.t.bundle.unpack(self.decode_up_vec(payload))

    def restore_uplink(self, payload: Payload) -> None:
        """Credit a never-applied uplink's reconstruction back into the EF
        residual (encode debited it assuming delivery)."""
        spec = CODECS[payload.codec]
        if not spec.ef:
            return
        data = payload.data
        recon = _dequant(*data) if spec.quantize else data
        self.residual = recon if self.residual is None \
            else self.residual + recon


class Transport:
    """Codec registry instance + per-worker links for one server.

    ``codec`` names the uplink codec, ``down_codec`` the downlink one
    (None = the same both ways; ``"raw"`` = uplink-only compression).
    ``raw_bytes`` defaults to the template's native byte size.
    ``ack_registry`` shares per-worker downlink ack state across servers.
    """

    def __init__(self, template, codec: str = "raw", *,
                 down_codec: Optional[str] = None, frac: float = 0.1,
                 raw_bytes: Optional[int] = None, mesh=None,
                 ack_registry: Optional[WorkerAckRegistry] = None):
        if down_codec is None:
            down_codec = codec
        for c in (codec, down_codec):
            if c == "auto":
                raise NotImplementedError(
                    "the auto codec resolver is not ported yet "
                    "(ROADMAP A5)")
            if c not in CODECS:
                raise ValueError(f"unknown codec {c!r}; have "
                                 f"{sorted(CODECS)}")
        self.spec_up = CODECS[codec]
        self.spec_down = CODECS[down_codec]
        self.frac = float(frac)
        self.bundle = flatbuf.bundle_for(template, mesh)
        self.raw_bytes = (int(raw_bytes) if raw_bytes is not None
                          else self.bundle.raw_bytes)
        self._ack_registry = ack_registry
        self._links: Dict[str, Link] = {}
        # retransmits over lossy links; stays 0 until they are ported
        # (ROADMAP A1)
        self.total_retransmits = 0
        # one packed copy of the current server model per dispatch round:
        # every selected worker's encode_down shares it (keyed on identity)
        self._down_tree = None
        self._down_vec: Optional[torch.Tensor] = None

    def _pack_down(self, weights_tree) -> torch.Tensor:
        if self._down_tree is not weights_tree:
            self._down_vec = self.bundle.pack(weights_tree)
            self._down_tree = weights_tree
        return self._down_vec

    @property
    def flat_capable(self) -> bool:
        return self.bundle is not None

    @property
    def tracks_tx_base(self) -> bool:
        """True when links carry a packed dispatch base (either direction
        is a delta codec)."""
        return self.spec_up.delta or self.spec_down.delta

    def note_round(self, point) -> None:
        """HistoryPoint feedback after each round, for the auto codec
        tuner; a no-op while ``auto`` raises (ROADMAP A1)."""

    def link(self, worker_id: str) -> Link:
        l = self._links.get(worker_id)
        if l is None:
            ack = (self._ack_registry.state(worker_id)
                   if self._ack_registry is not None else None)
            l = self._links[worker_id] = Link(self, ack, worker_id)
        return l

    # --- expected costs (selection time budgets / straggler timeouts) ---
    def expected_down_bytes(self) -> int:
        """Per-dispatch downlink estimate from the down codec spec (first
        contact costs ``raw_bytes``)."""
        return expected_codec_bytes(self.spec_down, self.bundle.n_params,
                                    self.raw_bytes, self.frac)

    def expected_up_bytes(self) -> int:
        """Per-response uplink estimate from the codec spec (top-k codecs:
        assumes exactly k survivors)."""
        return expected_codec_bytes(self.spec_up, self.bundle.n_params,
                                    self.raw_bytes, self.frac)

    def expected_oneway_bytes(self) -> int:
        """Mean per-direction bytes of a round trip: what the selection
        policies plug into the eq-3.4 time budget."""
        return (self.expected_down_bytes() + self.expected_up_bytes()) // 2
