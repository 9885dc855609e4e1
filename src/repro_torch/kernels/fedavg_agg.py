"""Fused (staleness-)weighted federated averaging over packed f32 rows.

``fedavg_agg_flat`` (``w @ rows``) and ``fedavg_mix_flat``
(``s * server + w @ rows``) replace the TPU kernels of
``repro/kernels/fedavg_agg.py``; ``fedavg_mix_wvec`` is the mix with the
server's scale as ``wvec[0]`` (the form the merge paths call, with an
in-place ``out``) and ``fedavg_delta_flat`` the mix with ``s = 1``.
``merge_opt_flat`` is either merge with the server optimizer's step
(``server_opt_step_flat``, re-exported here as in the JAX package) in the
same launch.  On a CUDA tensor they launch ``csrc/fedavg_agg.cu``; on a
CPU tensor they run the plain versions in ``ref.py``.  See the CUDA source
for the design and its bound.

Sharded variants (``*_sharded``, the JAX package's ``shard_map``
wrappers): the same kernels over a 1-D aggregation mesh
(``parallel.sharding.agg_mesh``), every buffer split along N.  Each
wrapper launches its kernel once per shard, on that shard's device and
under its device guard; the packed layout keeps every worker's lane of a
parameter on one device, so no shard reads another's data.  ``gather=True``
returns the whole ``(N,)`` result on the home device (the reference's one
``all_gather``); by default the result stays sharded.  Each per-shard
launch counts in its kernel's own counter (``LAUNCHES`` here, B5's in
``server_opt.LAUNCHES``), so a merge over D shards counts D launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.parallel import sharding as psh

from . import (check_cuda_tensor, check_status, output_tensor, ref,
               use_kernel)
from .server_opt import server_opt_step_flat

# kernel launches by wrapper (merge_opt_flat by optimizer form): a run
# shows it went through the kernels
LAUNCHES = {"agg": 0, "mix": 0, "merge_mom": 0, "merge_adam": 0}


def _check_rows(stacked: torch.Tensor, weights: torch.Tensor, n_w: int):
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be (W, N), got {tuple(stacked.shape)}")
    W, N = stacked.shape
    check_cuda_tensor(stacked, "stacked", torch.float32, W * N)
    check_cuda_tensor(weights, "weights", torch.float32, n_w)
    return W, N


def fedavg_agg_flat(stacked: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """stacked: (W, N) f32 rows; weights: (W,) f32.  Returns the new (N,)
    vector ``weights @ stacked``; never reads a server buffer."""
    if not use_kernel(stacked, weights):
        return ref.reference_fedavg(stacked, weights)
    from ._build import lib
    W, N = _check_rows(stacked, weights, stacked.shape[0])
    out = torch.empty(N, dtype=torch.float32, device=stacked.device)
    status = lib().fedavg_agg_launch(
        stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), W, N,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    check_status(status, "fedavg_agg_flat")
    LAUNCHES["agg"] += 1
    return out


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


def fedavg_mix_wvec(stacked: torch.Tensor, wvec: torch.Tensor,
                    server: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``wvec[0] * server + wvec[1:] @ stacked`` in one pass.

    stacked: (W, N) f32; wvec: (W + 1,) f32 (server scale first); server:
    (N,) f32.  ``out`` may be ``server`` itself (in-place merge) or None
    for a new vector.  On the CPU the result is computed out of place and
    copied into ``out`` when one is given."""
    if not use_kernel(stacked, wvec, server):
        res = ref.reference_fedavg_mix(stacked, wvec[1:], server, wvec[0])
        return res if out is None else out.copy_(res)
    from ._build import lib
    W, N = _check_rows(stacked, wvec, stacked.shape[0] + 1)
    check_cuda_tensor(server, "server", torch.float32, N)
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=server.device)
    else:
        check_cuda_tensor(out, "out", torch.float32, N)
        if out.device != server.device:
            raise ValueError("out must be on the server's device")
    status = lib().fedavg_mix_launch(
        stacked.data_ptr(), wvec.data_ptr(), server.data_ptr(),
        out.data_ptr(), W, N,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    check_status(status, "fedavg_mix_wvec")
    LAUNCHES["mix"] += 1
    return out


def fedavg_delta_flat(server: torch.Tensor, deltas: torch.Tensor,
                      weights: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta-accumulate: ``server + weights @ deltas`` (the mix, s = 1)."""
    wvec = torch.cat([torch.ones(1, dtype=torch.float32,
                                 device=weights.device), weights.float()])
    return fedavg_mix_wvec(deltas, wvec, server, out=out)


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
    sc = np.asarray(scalars, np.float32).reshape(-1)
    if sc.size != (6 if adam else 4):
        raise ValueError(f"expected {6 if adam else 4} scalars, got {sc.size}")
    tensors = [t for t in (stacked, wvec, server, prev, m, v if adam else None)
               if t is not None]
    if not use_kernel(*tensors):
        new, mo, vo = ref.reference_merge_opt(stacked, wvec, server, prev, m,
                                              v, sc, adam=adam)
        if out is not None:
            new = out.copy_(new)
        if m_out is not None:
            mo = m_out.copy_(mo)
        if adam and v_out is not None:
            vo = v_out.copy_(vo)
        return new, mo, vo
    from ._build import lib
    W, N = _check_rows(stacked, wvec, stacked.shape[0] + (server is not None))
    v = v if adam else None
    for t, name in ((server, "server"), (prev, "prev"), (m, "m"), (v, "v")):
        if t is not None:
            check_cuda_tensor(t, name, torch.float32, N)
    out = output_tensor(out, prev, "out", (stacked, wvec, m, v))
    mo = output_tensor(m_out, m, "m_out",
                       (stacked, wvec, server, prev, v, out))
    vo = (output_tensor(v_out, v, "v_out",
                        (stacked, wvec, server, prev, m, out, mo))
          if adam else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    status = lib().fedavg_merge_opt_launch(
        stacked.data_ptr(), wvec.data_ptr(), ptr(server), prev.data_ptr(),
        m.data_ptr(), ptr(v), out.data_ptr(), mo.data_ptr(), ptr(vo),
        int(adam), *(float(x) for x in sc[:4]), W, N,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    form = "adam" if adam else "mom"
    check_status(status, f"merge_opt_flat({form})")
    LAUNCHES[f"merge_{form}"] += 1
    return out, mo, vo


# ---------------------------------------------------------------------------
# Sharded variants (B7): one launch per shard over a 1-D server mesh
# ---------------------------------------------------------------------------

def _check_shardable(N: int, mesh, axis: str) -> int:
    D = mesh.shape[axis]
    if N % D:
        raise ValueError(f"flat buffer width {N} not divisible by the "
                         f"{D}-device '{axis}' mesh axis — pack with a "
                         f"mesh-aware ParamBundle (pads N to divisibility)")
    return D


def _per_shard(launch, mesh, split=(), copy=(), outs=(), gather=False):
    """``launch(*split_pieces, *copies, *out_pieces)`` once per shard of
    ``mesh``, under that shard's device guard.  ``split`` are (.., N)
    operands: a ``Sharded``'s own pieces, or a whole tensor split onto the
    mesh (None stays None); ``copy`` are small operands (the weights)
    copied to each device; ``outs`` are None or ``Sharded`` outputs
    written in place.  An operand passed twice (an in-place output) is the
    same pieces.  Returns each output of ``launch`` as a ``Sharded``
    (None stays None), a single one gathered on the home device with
    ``gather``."""
    if any(o is not None and not isinstance(o, psh.Sharded) for o in outs):
        raise ValueError("a sharded wrapper writes in place only into a "
                         "Sharded output")
    done = {}

    def pieces(x):
        if x is None:
            return (None,) * len(mesh.devices)
        if id(x) not in done:
            if isinstance(x, psh.Sharded):
                if x.mesh != mesh:
                    raise ValueError("operand sharded over another mesh")
                done[id(x)] = tuple(s.to(d) for s, d in
                                    zip(x.shards, mesh.devices))
            else:
                done[id(x)] = psh.split(x, mesh).shards
        return done[id(x)]

    split, outs = [pieces(x) for x in split], [pieces(x) for x in outs]
    copies = [{d: c.to(d) for d in set(mesh.devices)} for c in copy]
    results = []
    for i, dev in enumerate(mesh.devices):
        with psh.device_guard(dev):
            r = launch(*(p[i] for p in split), *(c[dev] for c in copies),
                       *(p[i] for p in outs))
        results.append(r if isinstance(r, tuple) else (r,))
    res = tuple(None if col[0] is None else psh.Sharded(col, mesh)
                for col in zip(*results))
    if len(res) > 1:
        return res
    return res[0].gather() if gather else res[0]


def fedavg_mix_wvec_sharded(stacked, wvec: torch.Tensor, server, *, mesh,
                            axis: str = psh.AGG_AXIS, gather: bool = False,
                            out=None):
    """``fedavg_mix_wvec`` per shard: ``stacked`` (W, N) and ``server``
    (N,) are ``Sharded`` (or whole, then split); ``wvec`` (W + 1,) is
    copied to each device.  ``out`` may be ``server`` (a ``Sharded``: the
    in-place merge) or None.  Returns the ``Sharded`` result, or the whole
    one on the home device with ``gather``."""
    _check_shardable(stacked.shape[-1], mesh, axis)
    return _per_shard(lambda r, s, w, o: fedavg_mix_wvec(r, w, s, out=o),
                      mesh, split=(stacked, server), copy=(wvec,),
                      outs=(out,), gather=gather)


def fedavg_mix_flat_sharded(stacked, weights, server, server_scale, *,
                            mesh, axis: str = psh.AGG_AXIS,
                            gather: bool = False):
    """``server_scale * server + weights @ stacked`` over a 1-D server
    mesh: each device runs B1 on its (W, N/D) rows and (N/D,) server
    slice (the JAX package's form and its ``shard_map`` wrapper)."""
    return fedavg_mix_wvec_sharded(
        stacked, _wvec(weights, server_scale, mesh.home), server, mesh=mesh,
        axis=axis, gather=gather)


def fedavg_agg_flat_sharded(stacked, weights, *, mesh,
                            axis: str = psh.AGG_AXIS, gather: bool = False):
    """Sharded ``weights @ stacked`` (no server term: the alpha >= 1
    replace path must not read the server buffer; see
    ``flatbuf.fused_weighted_sum``), one B2 launch per shard."""
    _check_shardable(stacked.shape[-1], mesh, axis)
    w = torch.as_tensor(weights, dtype=torch.float32).reshape(-1)
    return _per_shard(fedavg_agg_flat, mesh, split=(stacked,), copy=(w,),
                      gather=gather)


def merge_opt_flat_sharded(stacked, wvec: torch.Tensor, server, prev, m, v,
                           scalars, *, adam: bool, mesh,
                           axis: str = psh.AGG_AXIS, out=None, m_out=None,
                           v_out=None):
    """``merge_opt_flat`` per shard: the merge and the server optimizer's
    step in one launch on each device's slices; the aliasing rules of
    ``merge_opt_flat`` hold per shard (``out`` may be ``server`` and
    ``prev``, ``m_out`` ``m``, ``v_out`` ``v``).  Returns ``(new, m',
    v')`` as ``Sharded`` vectors, ``v'`` None when ``adam`` is False."""
    _check_shardable(stacked.shape[-1], mesh, axis)

    def launch(r, s, p, m_, v_, w, o, mo, vo):
        return merge_opt_flat(r, w, s, p, m_, v_, scalars, adam=adam, out=o,
                              m_out=mo, v_out=vo)
    return _per_shard(launch, mesh,
                      split=(stacked, server, prev, m, v if adam else None),
                      copy=(wvec,),
                      outs=(out, m_out, v_out if adam else None))


def server_opt_step_flat_sharded(prev, merged, m, v, scalars, *,
                                 adam: bool, mesh, axis: str = psh.AGG_AXIS,
                                 m_out=None, v_out=None):
    """Sharded optimizer step: every buffer is split along N and the
    update is elementwise, so each device runs B5 on its own (N/D,)
    slices, with no collective.  ``m_out``/``v_out`` may be ``m``/``v``
    (the state updates in place).  Returns ``(new, m', v')`` as
    ``Sharded`` vectors, ``v'`` None when ``adam`` is False."""
    _check_shardable(prev.shape[-1], mesh, axis)

    def launch(p, g, m_, v_, mo, vo):
        return server_opt_step_flat(p, g, m_, v_, scalars, adam=adam,
                                    m_out=mo, v_out=vo)
    return _per_shard(launch, mesh, split=(prev, merged, m,
                                           v if adam else None),
                      outs=(m_out, v_out if adam else None))
