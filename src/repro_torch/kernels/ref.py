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


def reference_server_opt(prev: torch.Tensor, merged: torch.Tensor,
                         m: torch.Tensor, v, scalars, *, adam: bool):
    """The fused server-optimizer step on ``d = merged - prev``.

    momentum form (``adam=False``, scalars ``[am, bm, cd, lr]``):
      ``m' = am*m + bm*d;  new = (prev + cd*d) + lr*m'``
    adam form (``adam=True``, scalars ``[b1, b2, lr, tau, 0, 0]``):
      ``m' = b1*m + (1-b1)*d;  v' = b2*v + ((1-b2)*d)*d;
      new = prev + (lr*m') / (sqrt(v') + tau)``

    Every operation is one rounded f32 op in this order, as in the JAX
    oracle and the CUDA kernel.  Returns ``(new, m', v')`` with ``v'``
    None in the momentum form."""
    f32 = torch.float32
    prev, merged, m = prev.float(), merged.float(), m.float()
    sc = torch.as_tensor(scalars, dtype=f32).to(prev.device)
    d = merged - prev
    if adam:
        mo = sc[0] * m + (1.0 - sc[0]) * d
        vo = sc[1] * v.to(f32) + (1.0 - sc[1]) * d * d
        return prev + sc[2] * mo / (torch.sqrt(vo) + sc[3]), mo, vo
    mo = sc[0] * m + sc[1] * d
    return prev + sc[2] * d + sc[3] * mo, mo, None
