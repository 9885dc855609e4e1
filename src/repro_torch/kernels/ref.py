"""Plain PyTorch versions of the CUDA kernels (the counterparts of
``repro/kernels/ref.py``).

Each repeats its kernel's arithmetic operation for operation: the fedavg
sums run over the rows in the fixed order 0..W-1, and every multiply and
add is a separate rounded PyTorch op, so on the card the kernels agree
with these bit for bit.  The CPU wrappers run these; ``chip_smoke.py``
holds each kernel against them.
"""
from __future__ import annotations

import torch


def _weighted_rows(stacked: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """``weights @ stacked`` as ``acc = acc + w[r] * row[r]``, r = 0..W-1.
    Every row is read, zero-weight ones included (0 * inf is NaN, as in
    JAX's contraction)."""
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for r in range(stacked.shape[0]):
        acc = acc + weights[r] * stacked[r]
    return acc


def reference_fedavg(stacked: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """(W, N) x (W,) -> (N,): ``weights @ stacked``; never reads a server
    buffer."""
    return _weighted_rows(stacked.float(), weights.float())


def reference_fedavg_mix(stacked: torch.Tensor, weights: torch.Tensor,
                         server: torch.Tensor, server_scale
                         ) -> torch.Tensor:
    """``server_scale * server + weights @ stacked``; ``server_scale`` is
    a float or a 0-d tensor."""
    acc = _weighted_rows(stacked.float(), weights.float())
    return server_scale * server.float() + acc


def reference_topk_quant_encode(x: torch.Tensor, thresh, scale):
    """Mask ``|x| < thresh``, quantise the rest to int8 (round half to
    even, clipped to +-127), and return ``(q, x - q * scale)``."""
    x = x.float()
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    q = torch.where(x.abs() >= thresh, q, torch.zeros_like(q))
    q = q.to(torch.int8)
    return q, x - q.float() * scale


def reference_dequant_add(q: torch.Tensor, scale, base: torch.Tensor
                          ) -> torch.Tensor:
    """``base + q * scale``: int8 ``q`` dequantised onto ``base``."""
    return base.float() + q.float() * scale
