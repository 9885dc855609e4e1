"""Fused (staleness-)weighted federated averaging over packed f32 rows.

``fedavg_agg_flat`` (``w @ rows``) and ``fedavg_mix_flat``
(``s * server + w @ rows``) replace the TPU kernels of
``repro/kernels/fedavg_agg.py``; ``fedavg_mix_wvec`` is the mix with the
server's scale as ``wvec[0]`` (the form the merge paths call, with an
in-place ``out``) and ``fedavg_delta_flat`` the mix with ``s = 1``.
``merge_opt_flat`` is either merge with the server optimizer's step
(``server_opt_step_flat``, re-exported here as in the JAX package) in the
same launch, and ``dequant_mix`` the mix over the rows ``(base + q *
scale, base)`` with B4's decode of the first in the same launch (the delta
merge of a quantised response: ``server + (new - base)``).  On a CUDA tensor they launch ``csrc/fedavg_agg.cu``; on a
CPU tensor they run the plain versions in ``ref.py``.  See the CUDA source
for the design and its bound.

Each has a form over *pieces* (``fedavg_agg_pieces``, ``fedavg_mix_pieces``,
``merge_opt_pieces``, ``dequant_mix_pieces``): equal-width operands on one
device, merged by one launch (one every ``GROUP_PIECES``); the unsharded
wrappers are its one-piece case.

Sharded variants (``*_sharded``, the JAX package's ``shard_map``
wrappers): the same kernels over a 1-D aggregation mesh
(``parallel.sharding.agg_mesh``), every buffer split along N.  Each
wrapper launches its kernel once a device, over every piece that device
holds (``parallel.sharding.device_groups``), under its device guard; the
packed layout keeps every worker's lane of a parameter on one device, so
no piece reads another's data.  On a mesh of distinct devices that is one
launch a piece; on one that repeats a card, one launch for all of the
card's pieces.  ``gather=True`` returns the whole ``(N,)`` result on the
home device (the reference's one ``all_gather``); by default the result
stays sharded.  Launches count in their kernel's counter (``LAUNCHES`` here,
B5's in ``server_opt.LAUNCHES``), the pieces they cover in ``PIECES``, so a
merge over D pieces on one card counts one launch and D pieces.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel import sharding as psh

from . import (check_cuda_tensor, check_status, group_launches,
               output_tensor, pointer_table, ref, use_kernel)
from .server_opt import server_opt_step_flat, server_opt_step_pieces

# kernel launches by wrapper (merge_opt_flat by optimizer form), and the
# pieces those launches covered: a run shows it went through the kernels
LAUNCHES = {"agg": 0, "mix": 0, "merge_mom": 0, "merge_adam": 0,
            "dequant_mix": 0}
PIECES = dict(LAUNCHES)

Pieces = Sequence[torch.Tensor]


def _count(key: str, n: int) -> None:
    LAUNCHES[key] += group_launches(n)
    PIECES[key] += n


def _check_pieces(rows: Pieces, weights: torch.Tensor, n_w: int):
    """(W, N) of every row piece (all equal), each a contiguous f32
    ``(W, N)`` tensor; ``weights`` ``n_w`` f32 values."""
    if not rows or rows[0].dim() != 2:
        raise ValueError(f"rows must be (W, N) pieces, got "
                         f"{[tuple(r.shape) for r in rows]}")
    W, N = rows[0].shape
    for r in rows:
        if r.shape != (W, N):
            raise ValueError(f"row pieces differ in shape: "
                             f"{tuple(r.shape)} and {(W, N)}")
        check_cuda_tensor(r, "stacked", torch.float32, W * N)
    check_cuda_tensor(weights, "weights", torch.float32, n_w)
    return W, N


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fedavg_agg_pieces(rows: Pieces, weights: torch.Tensor
                      ) -> List[torch.Tensor]:
    """``weights @ r`` for each ``(W, N)`` piece ``r`` of ``rows`` (all on
    one device, ``weights`` (W,) f32 there): new ``(N,)`` vectors, one
    launch for all the pieces; never reads a server buffer."""
    if not use_kernel(*rows, weights):
        return [ref.reference_fedavg(r, weights) for r in rows]
    from ._build import lib
    W, N = _check_pieces(rows, weights, rows[0].shape[0])
    outs = [torch.empty(N, dtype=torch.float32, device=r.device)
            for r in rows]
    status = lib().fedavg_agg_launch(
        pointer_table(rows, None, None, None, None, outs, None, None),
        len(rows), weights.data_ptr(), W, N, _stream(rows[0]))
    check_status(status, "fedavg_agg_flat")
    _count("agg", len(rows))
    return outs


def fedavg_agg_flat(stacked: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """stacked: (W, N) f32 rows; weights: (W,) f32.  Returns the new (N,)
    vector ``weights @ stacked``; never reads a server buffer."""
    return fedavg_agg_pieces([stacked], weights)[0]


def fedavg_mix_flat(stacked: torch.Tensor, weights: torch.Tensor,
                    server: torch.Tensor, server_scale) -> torch.Tensor:
    """The JAX package's form: ``server_scale * server + weights @
    stacked`` into a new vector.  stacked: (W, N) f32; weights: (W,);
    server: (N,) f32; ``server_scale`` a float or a 0-d tensor."""
    return fedavg_mix_wvec(stacked, _wvec(weights, server_scale,
                                          stacked.device), server)


def _wvec(weights, server_scale, device: torch.device) -> torch.Tensor:
    """``[server_scale, *weights]`` as one f32 vector on ``device``; a
    float scale is filled in on the device (no host copy)."""
    w = torch.as_tensor(weights, dtype=torch.float32).reshape(-1).to(device)
    if isinstance(server_scale, torch.Tensor):
        s = server_scale.to(device=device, dtype=torch.float32).reshape(1)
    else:
        s = torch.full((1,), float(server_scale), dtype=torch.float32,
                       device=device)
    return torch.cat([s, w])


def _none(pieces: Optional[Sequence], n: int) -> list:
    """One entry a piece: ``pieces``' own, or None for each."""
    return [None] * n if pieces is None else list(pieces)


def fedavg_mix_pieces(rows: Pieces, wvec: torch.Tensor, servers: Pieces,
                      outs: Optional[Sequence] = None
                      ) -> List[torch.Tensor]:
    """``wvec[0] * s + wvec[1:] @ r`` for each piece pair (``r`` (W, N)
    of ``rows``, ``s`` (N,) of ``servers``), one launch for all; ``outs``
    None or one entry a piece, each that piece's server itself (in place)
    or None (a new vector).  On the CPU each result is computed out of
    place and copied into its ``out`` when one is given."""
    outs = _none(outs, len(rows))
    if not use_kernel(*rows, wvec, *servers):
        res = [ref.reference_fedavg_mix(r, wvec[1:], s, wvec[0])
               for r, s in zip(rows, servers)]
        return [x if o is None else o.copy_(x) for x, o in zip(res, outs)]
    from ._build import lib
    W, N = _check_pieces(rows, wvec, rows[0].shape[0] + 1)
    for i, (s, o) in enumerate(zip(servers, outs)):
        check_cuda_tensor(s, "server", torch.float32, N)
        if o is None:
            outs[i] = torch.empty(N, dtype=torch.float32, device=s.device)
        else:
            check_cuda_tensor(o, "out", torch.float32, N)
            if o.device != s.device:
                raise ValueError("out must be on the server's device")
    status = lib().fedavg_mix_launch(
        pointer_table(rows, servers, None, None, None, outs, None, None),
        len(rows), wvec.data_ptr(), W, N, _stream(rows[0]))
    check_status(status, "fedavg_mix_wvec")
    _count("mix", len(rows))
    return outs


def fedavg_mix_wvec(stacked: torch.Tensor, wvec: torch.Tensor,
                    server: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``wvec[0] * server + wvec[1:] @ stacked`` in one pass.

    stacked: (W, N) f32; wvec: (W + 1,) f32 (server scale first); server:
    (N,) f32.  ``out`` may be ``server`` itself (in-place merge) or None
    for a new vector.  On the CPU the result is computed out of place and
    copied into ``out`` when one is given."""
    return fedavg_mix_pieces([stacked], wvec, [server], [out])[0]


def fedavg_delta_flat(server: torch.Tensor, deltas: torch.Tensor,
                      weights: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta-accumulate: ``server + weights @ deltas`` (the mix, s = 1)."""
    wvec = torch.cat([torch.ones(1, dtype=torch.float32,
                                 device=weights.device), weights.float()])
    return fedavg_mix_wvec(deltas, wvec, server, out=out)


def dequant_mix_pieces(qs: Pieces, scale: torch.Tensor, bases: Pieces,
                       wvec: torch.Tensor, servers: Pieces,
                       outs: Optional[Sequence] = None
                       ) -> List[torch.Tensor]:
    """``wvec[0] * s + (wvec[1] * (b + q * scale) + wvec[2] * b)`` for
    each piece triple (q (N,) int8 of ``qs``, b (N,) f32 of ``bases``, s
    (N,) f32 of ``servers``), all on one device with the 0-d ``scale`` and
    ``wvec`` (3,): B4's decode and B1 over the rows ``(b + q * scale, b)``
    in one launch for all the pieces, each rounded as the chain rounds it.
    ``outs`` None or one entry a piece, that piece's server itself (in
    place) or None (a new vector).  On the CPU
    ``ref.reference_dequant_mix``, copied into the ``out`` given."""
    outs = _none(outs, len(qs))
    if not use_kernel(*qs, scale, *bases, wvec, *servers):
        res = [ref.reference_dequant_mix(q, scale, b, s, wvec)
               for q, b, s in zip(qs, bases, servers)]
        return [x if o is None else o.copy_(x) for x, o in zip(res, outs)]
    from ._build import lib
    N = bases[0].numel()
    check_cuda_tensor(scale, "scale", torch.float32, 1)
    check_cuda_tensor(wvec, "wvec", torch.float32, 3)
    for i, (q, b, s, o) in enumerate(zip(qs, bases, servers, outs)):
        check_cuda_tensor(q, "q", torch.int8, N)
        check_cuda_tensor(b, "base", torch.float32, N)
        check_cuda_tensor(s, "server", torch.float32, N)
        if o is None:
            outs[i] = torch.empty(N, dtype=torch.float32, device=s.device)
        elif o is not s:
            outs[i] = output_tensor(o, s, "out", (q, b))
    status = lib().fedavg_dequant_mix_launch(
        pointer_table(qs, bases, servers, outs), len(qs), scale.data_ptr(),
        wvec.data_ptr(), N, _stream(bases[0]))
    check_status(status, "dequant_mix")
    _count("dequant_mix", len(qs))
    return outs


def dequant_mix(q: torch.Tensor, scale: torch.Tensor, base: torch.Tensor,
                wvec: torch.Tensor, server: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The delta merge of a quantised response in one pass:
    ``fedavg_mix_wvec(stack([dequant_add(q, scale, base), base]), wvec,
    server, out)`` with nothing between the two in memory.  q (N,) int8,
    scale 0-d f32, base and server (N,) f32, wvec (3,) f32; ``out`` may
    be ``server`` (the in-place merge) or None."""
    return dequant_mix_pieces([q], scale, [base], wvec, [server], [out])[0]


def _opt_scalars(scalars, adam: bool) -> np.ndarray:
    sc = np.asarray(scalars, np.float32).reshape(-1)
    if sc.size != (6 if adam else 4):
        raise ValueError(f"expected {6 if adam else 4} scalars, got {sc.size}")
    return sc


def merge_opt_pieces(rows: Pieces, wvec: torch.Tensor,
                     servers: Optional[Pieces], prevs: Pieces, ms: Pieces,
                     vs: Optional[Pieces], scalars, *, adam: bool,
                     outs: Optional[Sequence] = None,
                     m_outs: Optional[Sequence] = None,
                     v_outs: Optional[Sequence] = None):
    """``merge_opt_flat`` for each piece (every operand a sequence of
    pieces on one device, ``servers`` None for the aggregate and ``vs``
    None unless ``adam``), one launch for all.  Returns ``(news, m's,
    v's)``, lists of the pieces' results (``v's`` Nones unless ``adam``).
    ``outs``/``m_outs``/``v_outs`` are None or one entry a piece, with
    ``merge_opt_flat``'s aliasing rules a piece."""
    sc = _opt_scalars(scalars, adam)
    n = len(rows)
    servers, vs = _none(servers, n), _none(vs if adam else None, n)
    outs, m_outs, v_outs = (_none(outs, n), _none(m_outs, n),
                            _none(v_outs if adam else None, n))
    tensors = [t for t in (*rows, wvec, *servers, *prevs, *ms, *vs)
               if t is not None]
    if not use_kernel(*tensors):
        news, mos, vos = [], [], []
        for r, s, p, m, v, o, mo, vo in zip(rows, servers, prevs, ms, vs,
                                            outs, m_outs, v_outs):
            new, m1, v1 = ref.reference_merge_opt(r, wvec, s, p, m, v, sc,
                                                  adam=adam)
            news.append(new if o is None else o.copy_(new))
            mos.append(m1 if mo is None else mo.copy_(m1))
            vos.append(v1 if not adam or vo is None else vo.copy_(v1))
        return news, mos, vos
    from ._build import lib
    mix = servers[0] is not None
    W, N = _check_pieces(rows, wvec, rows[0].shape[0] + mix)
    for i in range(n):
        r, s, p, m, v = rows[i], servers[i], prevs[i], ms[i], vs[i]
        for t, name in ((s, "server"), (p, "prev"), (m, "m"), (v, "v")):
            if t is not None:
                check_cuda_tensor(t, name, torch.float32, N)
        if (s is not None) != mix:
            raise ValueError("a server piece in some pieces only")
        outs[i] = output_tensor(outs[i], p, "out", (r, wvec, m, v))
        m_outs[i] = output_tensor(m_outs[i], m, "m_out",
                                  (r, wvec, s, p, v, outs[i]))
        if adam:
            v_outs[i] = output_tensor(v_outs[i], v, "v_out",
                                      (r, wvec, s, p, m, outs[i], m_outs[i]))
    status = lib().fedavg_merge_opt_launch(
        pointer_table(rows, servers if mix else None, prevs, ms,
                      vs if adam else None, outs, m_outs,
                      v_outs if adam else None),
        n, wvec.data_ptr(), int(adam), *(float(x) for x in sc[:4]), W, N,
        _stream(rows[0]))
    form = "adam" if adam else "mom"
    check_status(status, f"merge_opt_flat({form})")
    _count(f"merge_{form}", n)
    return outs, m_outs, v_outs if adam else [None] * n


def merge_opt_flat(stacked: torch.Tensor, wvec: torch.Tensor,
                   server: Optional[torch.Tensor], prev: torch.Tensor,
                   m: torch.Tensor, v: Optional[torch.Tensor], scalars, *,
                   adam: bool, out: Optional[torch.Tensor] = None,
                   m_out: Optional[torch.Tensor] = None,
                   v_out: Optional[torch.Tensor] = None):
    """A merge and the server optimizer's step in one pass; returns
    ``(new, m', v')`` with ``v'`` None when ``adam`` is False.

    ``merged`` is ``wvec @ stacked`` when ``server`` is None (the
    aggregate, wvec (W,); the server is never read) or ``wvec[0] * server
    + wvec[1:] @ stacked`` (the mix, wvec (W + 1,)); then, on ``d = merged
    - prev``, the step of ``server_opt.server_opt_step_flat`` with the same
    ``scalars``.  ``merged`` itself is never written.  ``out`` may be
    ``server`` and ``prev`` (one buffer: the in-place merge), ``m_out``
    ``m`` and ``v_out`` ``v``; nothing else may alias, and None gives a new
    vector.  On the CPU the results are computed out of place and copied
    into the outputs that were given."""
    news, mos, vos = merge_opt_pieces(
        [stacked], wvec, None if server is None else [server], [prev], [m],
        [v] if adam else None, scalars, adam=adam, outs=[out],
        m_outs=[m_out], v_outs=[v_out])
    return news[0], mos[0], vos[0]


# ---------------------------------------------------------------------------
# Sharded variants (B7): one launch a device over a 1-D server mesh
# ---------------------------------------------------------------------------

def _check_shardable(N: int, mesh, axis: str) -> int:
    D = mesh.shape[axis]
    if N % D:
        raise ValueError(f"flat buffer width {N} not divisible by the "
                         f"{D}-device '{axis}' mesh axis — pack with a "
                         f"mesh-aware ParamBundle (pads N to divisibility)")
    return D


def _per_device(launch, mesh, split=(), copy=(), outs=(), gather=False):
    """``launch(*split_pieces, *copies, *out_pieces)`` once a device of
    ``mesh`` (``psh.device_groups``), under that device's guard, with the
    pieces it holds: ``split`` are (.., N) operands, a ``Sharded``'s own
    pieces or a whole tensor split onto the mesh; ``copy`` are small
    operands (the weights) copied to each device once; ``outs`` are None or
    ``Sharded`` outputs written in place.  An operand that is None is None
    in the call; an operand passed twice (an in-place output) is the same
    pieces.  ``launch`` returns each piece's results, in order.  Returns
    each output as a ``Sharded`` (None stays None), a single one gathered
    on the home device with ``gather``."""
    if any(o is not None and not isinstance(o, psh.Sharded) for o in outs):
        raise ValueError("a sharded wrapper writes in place only into a "
                         "Sharded output")
    done = {}

    def pieces(x):
        if x is None:
            return None
        if id(x) not in done:
            if isinstance(x, psh.Sharded):
                if x.mesh != mesh:
                    raise ValueError("operand sharded over another mesh")
                done[id(x)] = tuple(s.to(d) for s, d in
                                    zip(x.shards, mesh.devices))
            else:
                done[id(x)] = psh.split(x, mesh).shards
        return done[id(x)]

    def held(p, idx):
        return None if p is None else [p[i] for i in idx]

    split, outs = [pieces(x) for x in split], [pieces(x) for x in outs]
    results = [None] * len(mesh.devices)
    for dev, idx in psh.device_groups(mesh):
        with psh.device_guard(dev):
            res = launch(*(held(p, idx) for p in split),
                         *(c.to(dev) for c in copy),
                         *(held(p, idx) for p in outs))
        for i, r in zip(idx, res):
            results[i] = r if isinstance(r, tuple) else (r,)
    res = tuple(None if col[0] is None else psh.Sharded(col, mesh)
                for col in zip(*results))
    if len(res) > 1:
        return res
    return res[0].gather() if gather else res[0]


def fedavg_mix_wvec_sharded(stacked, wvec: torch.Tensor, server, *, mesh,
                            axis: str = psh.AGG_AXIS, gather: bool = False,
                            out=None):
    """``fedavg_mix_wvec`` over the mesh, one launch a device:
    ``stacked`` (W, N) and ``server`` (N,) are ``Sharded`` (or whole, then
    split); ``wvec`` (W + 1,) is copied to each device.  ``out`` may be
    ``server`` (a ``Sharded``: the in-place merge) or None.  Returns the
    ``Sharded`` result, or the whole one on the home device with
    ``gather``."""
    _check_shardable(stacked.shape[-1], mesh, axis)
    return _per_device(
        lambda r, s, w, o: fedavg_mix_pieces(r, w, s, outs=o),
        mesh, split=(stacked, server), copy=(wvec,), outs=(out,),
        gather=gather)


def dequant_mix_sharded(q, scale: torch.Tensor, base, wvec: torch.Tensor,
                        server, *, mesh, axis: str = psh.AGG_AXIS,
                        out=None):
    """``dequant_mix`` over the mesh, one launch a device over the pieces
    it holds: ``q``, ``base`` and ``server`` (N,) are ``Sharded`` (or
    whole, then split); ``scale`` and ``wvec`` are copied to each device.
    ``out`` may be ``server`` (a ``Sharded``: the in-place merge) or None.
    Returns the ``Sharded`` result."""
    _check_shardable(base.shape[-1], mesh, axis)
    return _per_device(
        lambda q_, b, s, sc, w, o: dequant_mix_pieces(q_, sc, b, w, s,
                                                      outs=o),
        mesh, split=(q, base, server), copy=(scale, wvec), outs=(out,))


def fedavg_mix_flat_sharded(stacked, weights, server, server_scale, *,
                            mesh, axis: str = psh.AGG_AXIS,
                            gather: bool = False):
    """``server_scale * server + weights @ stacked`` over a 1-D server
    mesh: each device runs B1 on its (W, N/D) rows and (N/D,) server
    slices (the JAX package's form and its ``shard_map`` wrapper)."""
    return fedavg_mix_wvec_sharded(
        stacked, _wvec(weights, server_scale, mesh.home), server, mesh=mesh,
        axis=axis, gather=gather)


def fedavg_agg_flat_sharded(stacked, weights, *, mesh,
                            axis: str = psh.AGG_AXIS, gather: bool = False):
    """Sharded ``weights @ stacked`` (no server term: the alpha >= 1
    replace path must not read the server buffer; see
    ``flatbuf.fused_weighted_sum``), one B2 launch a device."""
    _check_shardable(stacked.shape[-1], mesh, axis)
    w = torch.as_tensor(weights, dtype=torch.float32).reshape(-1)
    return _per_device(fedavg_agg_pieces, mesh, split=(stacked,),
                       copy=(w,), gather=gather)


def merge_opt_flat_sharded(stacked, wvec: torch.Tensor, server, prev, m, v,
                           scalars, *, adam: bool, mesh,
                           axis: str = psh.AGG_AXIS, out=None, m_out=None,
                           v_out=None):
    """``merge_opt_flat`` over the mesh: the merge and the server
    optimizer's step in one launch a device over its pieces; the aliasing
    rules of ``merge_opt_flat`` hold a piece (``out`` may be ``server``
    and ``prev``, ``m_out`` ``m``, ``v_out`` ``v``).  Returns ``(new, m',
    v')`` as ``Sharded`` vectors, ``v'`` None when ``adam`` is False."""
    _check_shardable(stacked.shape[-1], mesh, axis)

    def launch(r, s, p, m_, v_, w, o, mo, vo):
        return list(zip(*merge_opt_pieces(r, w, s, p, m_, v_, scalars,
                                          adam=adam, outs=o, m_outs=mo,
                                          v_outs=vo)))
    return _per_device(launch, mesh,
                       split=(stacked, server, prev, m, v if adam else None),
                       copy=(wvec,),
                       outs=(out, m_out, v_out if adam else None))


def server_opt_step_flat_sharded(prev, merged, m, v, scalars, *,
                                 adam: bool, mesh, axis: str = psh.AGG_AXIS,
                                 m_out=None, v_out=None):
    """Sharded optimizer step: every buffer is split along N and the
    update is elementwise, so each device runs B5 once on its own (N/D,)
    pieces, with no collective.  ``m_out``/``v_out`` may be ``m``/``v``
    (the state updates in place).  Returns ``(new, m', v')`` as
    ``Sharded`` vectors, ``v'`` None when ``adam`` is False."""
    _check_shardable(prev.shape[-1], mesh, axis)

    def launch(p, g, m_, v_, mo, vo):
        return list(zip(*server_opt_step_pieces(
            p, g, m_, v_, scalars, adam=adam, m_outs=mo, v_outs=vo)))
    return _per_device(launch, mesh, split=(prev, merged, m,
                                            v if adam else None),
                       outs=(m_out, v_out if adam else None))
