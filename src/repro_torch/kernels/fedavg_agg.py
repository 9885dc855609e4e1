"""Fused (staleness-)weighted federated averaging over packed f32 rows.

``fedavg_agg_flat`` (``w @ rows``) and ``fedavg_mix_flat``
(``s * server + w @ rows``) replace the TPU kernels of
``repro/kernels/fedavg_agg.py``; ``fedavg_delta_flat`` is the mix with
``s = 1``.  ``merge_opt_flat`` is either merge with the server
optimizer's step (``server_opt_step_flat``) in the same launch.  On a
CUDA tensor they launch ``csrc/fedavg_agg.cu``; on a CPU tensor they run
the plain versions in ``ref.py``.  See the CUDA source for the design and
its bound.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import (check_cuda_tensor, check_status, output_tensor, ref,
               use_kernel)

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


def fedavg_mix_flat(stacked: torch.Tensor, wvec: torch.Tensor,
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
    check_status(status, "fedavg_mix_flat")
    LAUNCHES["mix"] += 1
    return out


def fedavg_delta_flat(server: torch.Tensor, deltas: torch.Tensor,
                      weights: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta-accumulate: ``server + weights @ deltas`` (the mix, s = 1)."""
    wvec = torch.cat([torch.ones(1, dtype=torch.float32,
                                 device=weights.device), weights.float()])
    return fedavg_mix_flat(deltas, wvec, server, out=out)


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
