"""Fused (staleness-)weighted federated averaging over packed f32 rows.

``fedavg_agg_flat`` (``w @ rows``) and ``fedavg_mix_flat``
(``s * server + w @ rows``) replace the TPU kernels of
``repro/kernels/fedavg_agg.py``; ``fedavg_delta_flat`` is the mix with
``s = 1``.  On a CUDA tensor they launch ``csrc/fedavg_agg.cu``; on a CPU
tensor they run the plain versions in ``ref.py``.  See the CUDA source
for the design and its bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import check_cuda_tensor, check_status, ref, use_kernel

# kernel launches by wrapper: a run shows it went through the kernels
LAUNCHES = {"agg": 0, "mix": 0}


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
