"""Flat-buffer aggregation path (port of ``repro/core/flatbuf.py``).

* ``ParamBundle`` packs a dict of tensors into one contiguous f32 vector
  (leaves in sorted key order, JAX's pytree order, so packed vectors line
  up with the JAX package), padded to a multiple of ``BLOCK`` with a zero
  tail that stays zero through every merge.
* ``FlatServerState`` owns a persistent ``(W_cap, N)`` row buffer and the
  packed server mirror, and merges with one kernel pass:
  ``fused_merge`` (``fedavg_mix_flat``: ``wvec[0]*server + wvec[1:] @
  rows``) or, for alpha >= 1, ``fused_weighted_sum`` (``fedavg_agg_flat``,
  which never reads the server buffer); with an active server optimizer,
  ``fused_merge_opt`` (``merge_opt_flat``) takes the optimizer's step in
  that same pass.  ``merge_rows`` also takes ``EncodedVec``s, quantised
  responses still encoded, and decodes all of them into their rows in one
  ``dequant_add_rows`` launch; ``delta_vec`` takes one and decodes and
  merges it in one ``dequant_mix`` launch.

JAX arrays are immutable; these are not.  The only in-place writes on
the merge path are the mix's (``fused_merge``, ``fused_merge_opt``) into
the packed server mirror, which ``_server_buffer`` hands over and forgets
(the counterpart of JAX's donation), and the server optimizer's moments.
An attached server optimizer, whose ``prev`` anchor may be that buffer,
is told (``ServerOpt.release``); the fused merge then takes the buffer
itself as ``prev``, and ``step_vec`` re-packs it.  ``unpack`` returns
copies, so no weight dict handed out before a merge aliases a buffer the
merge writes.

Sharded substrate: with ``mesh=`` (a 1-D ``parallel.sharding.agg_mesh``)
the bundle pads N to ``BLOCK * n_shards`` and the flat state holds its
row buffer and server mirror as ``Sharded`` pieces, one a mesh entry,
and merges through the sharded kernels (one launch a device over the
pieces it holds: B7).  The
transport's link vectors and decoded responses are ``Sharded`` over the
same mesh (``core/transport.py``), an ``EncodedVec`` holds ``Sharded`` q
and base, and ``_set_rows`` lands each shard's own piece in its rows (an
encoded merge decoded by one ``dequant_add_rows`` launch a device, from
pieces already on that device); a whole vector (``bundle.pack``) is
sliced there instead.  ``unpack`` gathers the shards on the home device.
Every element is computed by the same arithmetic as unsharded, so a
sharded merge equals the unsharded one bit for bit at any mesh size.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import fedavg_agg, topk_quant
from repro_torch.parallel import sharding as psh

BLOCK = 512          # pack pads N up to a multiple


def padded_size_for(n_params: int, n_shards: int = 1) -> int:
    """Packed width of an ``n_params`` model: a multiple of ``BLOCK *
    n_shards``."""
    lane = BLOCK * max(1, int(n_shards))
    return -(-int(n_params) // lane) * lane


def shard_spans(lo: int, hi: int, shard_size: int):
    """Mesh-aware offsets: the global param range ``[lo, hi)`` split into
    shard-local slices, one ``(shard, local_lo, local_hi, global_lo)``
    tuple per device the range touches (a leaf crossing a shard boundary
    owns one span per device)."""
    spans = []
    d = lo // shard_size
    while lo < hi:
        end = min(hi, (d + 1) * shard_size)
        spans.append((d, lo - d * shard_size, end - d * shard_size, lo))
        lo, d = end, d + 1
    return tuple(spans)


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, psh.AggMesh):
        raise TypeError(f"mesh must be a parallel.sharding.agg_mesh, got "
                        f"{type(mesh).__name__}")


@dataclass(frozen=True)
class EncodedVec:
    """A packed vector still encoded: ``base + q * scale`` (q (N,) int8,
    scale 0-d f32, base the (N,) f32 vector it was encoded against, pinned
    when the response arrived; on a sharded server q and base are
    ``Sharded`` and the scale lies on the home device).  ``merge_rows``
    decodes every one of a merge straight into its row in one launch (one
    a device), ``delta_vec`` decodes and merges one in one launch."""
    q: object
    scale: torch.Tensor
    base: object


def packable(tree) -> bool:
    """True for a non-empty dict of tensors (packs into one buffer)."""
    return (isinstance(tree, Mapping) and bool(tree)
            and all(isinstance(v, torch.Tensor) for v in tree.values()))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  On the card the copy goes through
    pinned memory without blocking the host, so it adds no sync."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class ParamBundle:
    """Pack/unpack one model structure to/from a flat f32 buffer.

    Keys, shapes, dtypes and offsets are fixed at construction.  With
    ``mesh``, N pads to ``BLOCK * n_shards``; ``shard_bounds`` and
    ``leaf_spans`` give the mesh-aware offset table (which device owns
    which slice of which leaf)."""

    def __init__(self, template: Mapping[str, torch.Tensor], mesh=None):
        _check_mesh(mesh)
        if not packable(template):
            raise ValueError("cannot bundle: expected a non-empty dict of "
                             "tensors")
        self.keys = tuple(sorted(template))
        self.shapes = tuple(tuple(template[k].shape) for k in self.keys)
        self.dtypes = tuple(template[k].dtype for k in self.keys)
        self.sizes = tuple(int(np.prod(s, dtype=np.int64)) if s else 1
                           for s in self.shapes)
        off = np.concatenate([[0], np.cumsum(self.sizes)])
        self.offsets = tuple(int(o) for o in off[:-1])
        self.n_params = int(off[-1])
        # bytes of the model at its native dtypes: what a raw (uncoded)
        # wire transfer of this structure costs (core/transport.py)
        self.raw_bytes = int(sum(n * torch.empty((), dtype=d).element_size()
                                 for n, d in zip(self.sizes, self.dtypes)))
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.shape[psh.AGG_AXIS]
        self.padded_size = padded_size_for(self.n_params, self.n_shards)
        self.shard_size = self.padded_size // self.n_shards
        # every leaf f32: a packed vector unpacked and packed again keeps
        # its bits
        self.f32 = all(d == torch.float32 for d in self.dtypes)

    # --- mesh-aware offsets ---
    def shard_bounds(self, shard: int):
        """Global ``[lo, hi)`` param range device ``shard`` owns."""
        if not 0 <= shard < self.n_shards:
            raise IndexError(shard)
        return shard * self.shard_size, (shard + 1) * self.shard_size

    def leaf_spans(self, leaf: int):
        """Shard-local slices of leaf ``leaf``: ``(shard, local_lo,
        local_hi, global_lo)`` per device the leaf touches."""
        o = self.offsets[leaf]
        return shard_spans(o, o + self.sizes[leaf], self.shard_size)

    def pack(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """tree -> new (padded_size,) f32 flat buffer (zero tail)."""
        parts = [tree[k].reshape(-1).to(torch.float32) for k in self.keys]
        pad = self.padded_size - self.n_params
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def pack_many(self, trees: Sequence) -> torch.Tensor:
        """[tree] * W -> (W, padded_size) stacked flat buffers."""
        return torch.stack([self.pack(t) for t in trees])

    def pack_into(self, rows: torch.Tensor, trees: Sequence) -> torch.Tensor:
        """Pack W trees into the first W rows of ``rows`` (zeroing the
        rest), in place; returns ``rows``."""
        return self._set_rows(rows, [self.pack(t) for t in trees])

    def _set_rows(self, rows: torch.Tensor, vecs: Sequence) -> torch.Tensor:
        """Land packed vectors in rows [0..len(vecs)) and zero the stale
        rows beyond: a non-finite value left by a past round would turn
        0 * inf into NaN inside the merge.  A merge of ``EncodedVec``s
        alone is decoded into its rows, with the stale rows zeroed, by one
        ``dequant_add_rows``; in a merge that mixes both kinds (an auto
        transport's links resolve codecs apart) each encoded one is
        decoded by ``dequant_add`` first.  Sharded ``rows`` take each
        shard's slice of every vector (for an encoded merge one
        ``dequant_add_rows_pieces`` a device, over the pieces it holds)."""
        if isinstance(rows, psh.Sharded):
            self._set_sharded_rows(rows, vecs)
            return rows
        if vecs and all(isinstance(v, EncodedVec) for v in vecs):
            return topk_quant.dequant_add_rows(
                [v.q for v in vecs], [v.scale for v in vecs],
                [v.base for v in vecs], rows)
        vecs = [topk_quant.dequant_add(v.q, v.scale, v.base)
                if isinstance(v, EncodedVec) else v for v in vecs]
        n = len(vecs)
        if n:
            torch.stack(tuple(vecs), out=rows[:n])
        rows[n:].zero_()
        return rows

    def _set_sharded_rows(self, rows: "psh.Sharded", vecs: Sequence):
        n = len(vecs)
        encoded = bool(vecs) and all(isinstance(v, EncodedVec)
                                     for v in vecs)
        if not encoded:
            vecs = [topk_quant.dequant_add(v.q, v.scale, v.base)
                    if isinstance(v, EncodedVec) else v for v in vecs]
        for dev, idx in psh.device_groups(rows.mesh):
            spans = [(d, *self.shard_bounds(d)) for d in idx]
            if encoded:
                with psh.device_guard(dev):
                    topk_quant.dequant_add_rows_pieces(
                        [[shard_piece(v.q, *sp, dev) for sp in spans]
                         for v in vecs],
                        [v.scale.to(dev) for v in vecs],
                        [[shard_piece(v.base, *sp, dev) for sp in spans]
                         for v in vecs],
                        [rows.shards[d] for d in idx])
                continue
            for d, lo, hi in spans:
                piece = rows.shards[d]
                if n:
                    torch.stack([shard_piece(v, d, lo, hi, dev)
                                 for v in vecs], out=piece[:n])
                piece[n:].zero_()

    def unpack(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(padded_size,) or (n_params,) buffer -> dict of new tensors at
        the original dtypes (copies: never views into ``flat``).  A
        ``Sharded`` buffer is gathered on the home device first."""
        if isinstance(flat, psh.Sharded):
            flat = flat.gather()
        return {k: flat[o:o + n].reshape(s).to(d, copy=True)
                for k, o, n, s, d in zip(self.keys, self.offsets, self.sizes,
                                         self.shapes, self.dtypes)}


_BUNDLES: Dict[tuple, ParamBundle] = {}


def bundle_for(template, mesh=None) -> ParamBundle:
    """Memoised ParamBundle keyed on (keys, shapes, dtypes, mesh): the
    server and its transport resolve to the SAME (mesh-aware) bundle, so
    decoded vectors match the row buffer's padded width."""
    _check_mesh(mesh)
    key = (tuple((k, tuple(template[k].shape), str(template[k].dtype))
                 for k in sorted(template)), mesh)
    b = _BUNDLES.get(key)
    if b is None:
        b = _BUNDLES[key] = ParamBundle(template, mesh=mesh)
    return b


def shard_piece(v, d: int, lo: int, hi: int, dev: torch.device
                ) -> torch.Tensor:
    """Shard ``d``'s slice ``[lo, hi)`` of a packed vector on ``dev``:
    a ``Sharded`` vector's own piece, or a whole vector's slice."""
    if isinstance(v, psh.Sharded):
        return v.shards[d].to(dev)
    return v[lo:hi].to(dev)


# --- fused merge ops -------------------------------------------------------
# wvec = [server_scale, w_0 .. w_{Wcap-1}]; rows beyond the live W carry
# weight 0, so capacity growth never changes the result.

def _weights_on(w, device: torch.device) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.to(device=device, dtype=torch.float32)
    return to_device(np.asarray(w, np.float32), device)


def fused_merge(server_flat, rows, wvec, mesh=None):
    """One pass ``wvec[0]*server + wvec[1:] @ rows``, written into
    ``server_flat`` in place and returned: callers treat ``server_flat``
    as consumed.  With ``mesh`` (``server_flat`` then ``Sharded``) the
    pass runs once a device over its pieces and returns the ``Sharded``
    result."""
    if mesh is not None:
        return fedavg_agg.fedavg_mix_wvec_sharded(
            rows, _weights_on(wvec, mesh.home), server_flat, mesh=mesh,
            out=server_flat)
    return fedavg_agg.fedavg_mix_wvec(
        rows, _weights_on(wvec, rows.device), server_flat, out=server_flat)


def fused_merge_opt(rows, w, server, prev, m, v, scalars, *, adam: bool,
                    mesh=None):
    """One pass: the merge (``fused_weighted_sum`` when ``server`` is None,
    else ``fused_merge``, written into ``server`` in place, which may also
    be ``prev``) and the server optimizer's step on its result, ``m`` and
    ``v`` updated in place.  Returns the stepped vector (``Sharded`` with
    ``mesh``: one launch a device)."""
    if mesh is not None:
        new, _, _ = fedavg_agg.merge_opt_flat_sharded(
            rows, _weights_on(w, mesh.home), server, prev, m, v, scalars,
            adam=adam, mesh=mesh, out=server, m_out=m, v_out=v)
        return new
    new, _, _ = fedavg_agg.merge_opt_flat(
        rows, _weights_on(w, rows.device), server, prev, m, v, scalars,
        adam=adam, out=server, m_out=m, v_out=v)
    return new


def fused_weighted_sum(rows, w, mesh=None):
    """One pass ``w @ rows`` into a new vector, with no server term: the
    alpha >= 1 replace path must not read the server buffer at all
    (``0 * server`` would turn a non-finite server model into NaN instead
    of replacing it).  With ``mesh``: one launch a device, ``Sharded``
    result."""
    if mesh is not None:
        return fedavg_agg.fedavg_agg_flat_sharded(
            rows, _weights_on(w, mesh.home), mesh=mesh)
    return fedavg_agg.fedavg_agg_flat(rows, _weights_on(w, rows.device))


def normalized_weights(weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    s = w.sum()
    if s <= 0:
        raise ValueError("aggregation weights sum to zero")
    return (w / s).astype(np.float32)


def flat_state_for(weights, mesh=None) -> Optional["FlatServerState"]:
    """The flat-buffer merge state for an aggregator over ``weights``, or
    None when the weights are not a packable dict of tensors."""
    if packable(weights):
        return FlatServerState(weights, mesh=mesh)
    return None


_DELTA_WVEC = np.asarray([1.0, 1.0, -1.0], np.float32)


class FlatServerState:
    """Persistent flat-buffer merge state for one AggregationServer.

    Keeps (a) the packed server model, mirrored against the weight dict
    the server hands in (re-packed only when that dict is not the one the
    last merge produced: an identity check), and (b) a pre-allocated
    ``(W_cap, N)`` row buffer on the weights' device.

    With ``mesh`` both are ``Sharded`` along N over the 1-D server mesh
    (rows ``(W_cap, N/D)`` and mirror ``(N/D,)`` a device) and every merge
    runs per shard: per-device bytes of the substrate shrink linearly with
    the mesh.  The weights' device must be the mesh's home device."""

    def __init__(self, template, mesh=None):
        self.bundle = bundle_for(template, mesh)
        self.mesh = mesh
        self.device = next(iter(template.values())).device
        if mesh is not None and mesh.home != self.device:
            raise ValueError(f"the weights live on {self.device}, the "
                             f"mesh's home device is {mesh.home}")
        self._rows: Optional[torch.Tensor] = None
        self._server_flat: Optional[torch.Tensor] = None
        self._server_tree = None          # strong ref: the mirror's key
        # cohort row window: recycled rows in a min-heap (claims reuse the
        # LOWEST free index, so a sync round lands in rows [0..n) in
        # arrival order, the merge_rows layout); released rows are zeroed
        # lazily, batched right before the next merge
        self._free: list = []
        self._next_row = 0
        self._dirty: set = set()
        self._delta_w: Optional[torch.Tensor] = None
        # optional core.server_opt.ServerOpt: its step runs in the merge's
        # own pass (set by the server)
        self.server_opt = None

    @property
    def capacity(self) -> int:
        return 0 if self._rows is None else int(self._rows.shape[0])

    def _ensure_capacity(self, w: int):
        if self.capacity >= w:
            return
        if self.mesh is not None:
            # allocated a shard a device: the whole (W, N) buffer never
            # exists on one device
            old = (None,) * self.bundle.n_shards if self._rows is None \
                else self._rows.shards
            self._rows = psh.Sharded(
                [_grown(o, w, self.bundle.shard_size, dev)
                 for o, dev in zip(old, self.mesh.devices)], self.mesh)
            return
        self._rows = _grown(self._rows, w, self.bundle.padded_size,
                            self.device)

    def pack(self, tree):
        """``tree`` packed as the merge reads it: whole, or ``Sharded``
        over the mesh."""
        vec = self.bundle.pack(tree)
        if self.mesh is None:
            return vec
        return psh.split(vec, self.mesh)

    def _server_buffer(self, server_tree) -> torch.Tensor:
        """The packed server model, handed over to an in-place merge: the
        mirror is forgotten, so nothing else holds the buffer it writes."""
        if (self._server_flat is None
                or self._server_tree is not server_tree):
            self._server_flat = self.pack(server_tree)
        buf = self._server_flat
        self._server_flat = None
        if self.server_opt is not None:
            # the optimizer's prev anchor may be this very buffer
            self.server_opt.release(buf)
        return buf

    def forget_server(self) -> None:
        """The server model was replaced from outside (a leaf's install of
        a new global): drop the packed mirror of the old one."""
        self._server_flat = None
        self._server_tree = None

    def merge(self, server_tree, update_trees: Sequence,
              weights: Sequence[float], alpha: float = 1.0):
        """Fused ``(1-alpha)*server + alpha * sum_i w_hat_i * x_i``;
        returns the merged weight dict."""
        n = len(update_trees)
        self._ensure_capacity(n)
        self.bundle.pack_into(self._rows, update_trees)
        return self._merge(server_tree, np.arange(n), weights, alpha)

    def merge_rows(self, server_tree, update_vecs: Sequence,
                   weights: Sequence[float], alpha: float = 1.0):
        """The same merge over already-packed ``(padded_size,)`` vectors
        or ``EncodedVec``s, decoded into their rows here."""
        n = len(update_vecs)
        self._ensure_capacity(n)
        self.bundle._set_rows(self._rows, update_vecs)
        return self._merge(server_tree, np.arange(n), weights, alpha)

    def _merge(self, server_tree, idx: np.ndarray, weights: Sequence[float],
               alpha: float):
        """One kernel pass over the row buffer: row ``idx[i]`` weighted by
        ``weights[i]`` (every other row by 0), mixed with the server when
        alpha < 1, and stepped by the server optimizer unless it has none
        or a degenerate one."""
        w = normalized_weights(weights)
        if alpha >= 1.0:
            wv = np.zeros((self.capacity,), np.float32)
            wv[idx] = w
            server = None
        else:
            wv = np.zeros((self.capacity + 1,), np.float32)
            wv[0] = 1.0 - alpha
            wv[idx + 1] = alpha * w
            server = self._server_buffer(server_tree)
        opt = self.server_opt
        # the server buffer is the bits of pack(server_tree) when every
        # leaf is f32: then it is prev too, and prev is not re-packed
        ops = None if opt is None else opt.merge_operands(
            self, server_tree, server if self.bundle.f32 else None)
        if ops is not None:
            merged = fused_merge_opt(self._rows, wv, server, *ops,
                                     adam=opt.adam, mesh=self.mesh)
        elif server is None:
            merged = fused_weighted_sum(self._rows, wv, mesh=self.mesh)
        else:
            merged = fused_merge(server, self._rows, wv, mesh=self.mesh)
        return self._finish(server_tree, merged)

    def _finish(self, server_tree, merged: torch.Tensor):
        """Merge epilogue: unpack (copies), and keep the packed result as
        the mirror of the returned dict and the server optimizer's next
        ``prev``."""
        out = self.bundle.unpack(merged)
        self._server_flat, self._server_tree = merged, out
        if self.server_opt is not None:
            self.server_opt.note_result(merged, out)
        return out

    # --- cohort row window --------------------------------------------
    def win_claim(self) -> int:
        """Claim a free row of the window for one in-flight update."""
        if self._free:
            return heapq.heappop(self._free)
        row = self._next_row
        self._next_row += 1
        if row >= self.capacity:
            # geometric growth (zero rows at weight 0 never change a merge)
            self._ensure_capacity(max(row + 1, 2 * self.capacity, 8))
        return row

    def win_write(self, row: int, vec) -> None:
        """Land one already-packed update vector in its claimed row."""
        if self.mesh is None:
            self._rows[row] = vec
        else:
            for d, (piece, dev) in enumerate(zip(self._rows.shards,
                                                 self.mesh.devices)):
                piece[row] = shard_piece(vec, d,
                                         *self.bundle.shard_bounds(d), dev)
        self._dirty.discard(row)

    def win_release(self, row: int) -> None:
        """Recycle a row; its stale data is zeroed before the next merge."""
        heapq.heappush(self._free, row)
        self._dirty.add(row)

    def _flush_dirty(self) -> None:
        if not self._dirty:
            return
        idx = sorted(self._dirty)
        for piece in (self._rows.shards if self.mesh is not None
                      else (self._rows,)):
            piece[idx] = 0.0
        self._dirty.clear()

    def merge_window(self, server_tree, rows: Sequence[int],
                     weights: Sequence[float], alpha: float = 1.0):
        """Fused merge over the row window: ``rows[i]`` carries the update
        weighted by ``weights[i]``; every other row gets weight 0."""
        self._flush_dirty()
        return self._merge(server_tree, np.asarray(tuple(rows), np.intp),
                           weights, alpha)

    def row_vec(self, row: int):
        """A copy of one claimed row as a packed flat vector (``Sharded``
        with a mesh)."""
        return self._rows[row].clone()

    def _delta_weights(self) -> torch.Tensor:
        if self._delta_w is None:
            self._delta_w = _weights_on(_DELTA_WVEC, self.device)
        return self._delta_w

    def apply_delta(self, cur_tree, new_tree, base_tree):
        """``cur + (new - base)`` as one fused pass over packed buffers;
        returns a weight dict."""
        rows = self.bundle.pack_many((new_tree, base_tree))
        cur = self.pack(cur_tree)
        return self.bundle.unpack(
            fused_merge(cur, rows, self._delta_weights(), mesh=self.mesh))

    def delta_vec(self, cur_tree, new_vec, base_vec):
        """``cur + (new - base)`` on packed vectors (with a mesh,
        ``Sharded`` ones stacked piece by piece into a ``Sharded`` (2,
        N/D); whole ones sliced); returns the packed result (``Sharded``
        with a mesh), written into the server mirror (which is
        consumed).  ``new_vec`` may be an ``EncodedVec`` encoded against
        ``base_vec`` itself (a quantised response, its base pinned at
        arrival): then its decode and the merge are one ``dequant_mix``
        launch (one a device with a mesh), with no stack."""
        if isinstance(new_vec, EncodedVec):
            if new_vec.base is base_vec:
                server = self._server_buffer(cur_tree)
                w = self._delta_weights()
                if self.mesh is None:
                    return fedavg_agg.dequant_mix(
                        new_vec.q, new_vec.scale, base_vec, w, server,
                        out=server)
                return fedavg_agg.dequant_mix_sharded(
                    new_vec.q, new_vec.scale, base_vec, w, server,
                    mesh=self.mesh, out=server)
            new_vec = topk_quant.dequant_add(new_vec.q, new_vec.scale,
                                             new_vec.base)
        if self.mesh is None:
            rows = torch.stack([new_vec, base_vec])
        else:
            rows = psh.Sharded([
                torch.stack([shard_piece(v, d, *self.bundle.shard_bounds(d),
                                         dev) for v in (new_vec, base_vec)])
                for d, dev in enumerate(self.mesh.devices)], self.mesh)
        return fused_merge(self._server_buffer(cur_tree), rows,
                           self._delta_weights(), mesh=self.mesh)


def _grown(old: Optional[torch.Tensor], w: int, n: int,
           device: torch.device) -> torch.Tensor:
    """A zero ``(w, n)`` f32 buffer on ``device`` holding ``old``'s rows
    first."""
    new = torch.zeros((w, n), dtype=torch.float32, device=device)
    if old is not None:
        new[:old.shape[0]] = old
    return new
