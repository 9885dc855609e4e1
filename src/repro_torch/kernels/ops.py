"""Public entry points to the kernels (port of ``repro/kernels/ops.py``).

Each goes to its CUDA kernel on a CUDA tensor and to the kernel's plain
PyTorch version on a CPU tensor, by the rule of ``kernels.use_kernel``;
there is no ``interpret`` switch.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from . import fedavg_agg as _fedavg
from . import flash_attention as _fa
from . import rwkv6_kernel as _wkv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Forward flash attention (B8); see
    ``flash_attention.flash_attention``."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def fedavg_aggregate(trees: Sequence[Mapping[str, torch.Tensor]], weights
                     ) -> dict:
    """Weighted average of W parameter dicts through one launch of the
    fused kernel (B2) over their packed ``(W, N)`` buffer.  ``weights``:
    (W,), normalised here (unnormalised is fine).  Returns a new dict at
    the parameters' dtypes."""
    from repro_torch.core import flatbuf
    bundle = flatbuf.bundle_for(trees[0])
    stacked = bundle.pack_many(trees)
    w = torch.as_tensor(weights, dtype=torch.float32, device=stacked.device)
    w = w / torch.clamp(w.sum(), min=1e-9)
    return bundle.unpack(_fedavg.fedavg_agg_flat(stacked, w))


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16) -> torch.Tensor:
    """The chunked RWKV-6 WKV recurrence from a zero state (B9); see
    ``rwkv6_kernel.wkv``."""
    return _wkv.wkv(r, k, v, w, u, chunk=chunk)
