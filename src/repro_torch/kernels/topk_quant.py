"""Fused top-k threshold + int8 quantise encode, and fused dequantise +
delta-apply decode, over a packed f32 vector.

``topk_quant_encode`` and ``dequant_add`` replace the TPU kernels of
``repro/kernels/topk_quant.py``.  On a CUDA tensor they launch
``csrc/topk_quant.cu``; on a CPU tensor they run the plain versions in
``ref.py``.  See the CUDA source for the design and its bound.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from . import check_cuda_tensor, check_status, ref, use_kernel

# kernel launches by wrapper: a run shows it went through the kernels
LAUNCHES = {"encode": 0, "decode": 0}

Scalar = Union[float, torch.Tensor]


def _scalar_on(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device.  A Python float is filled on
    the card (no host-to-device copy, no sync)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"expected a scalar tensor, got {tuple(v.shape)}")
        if v.device != like.device:
            raise ValueError(f"scalar on {v.device}, data on {like.device}")
        return v.reshape(()).to(torch.float32).contiguous()
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def topk_quant_encode(x: torch.Tensor, thresh: Scalar, scale: Scalar
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over x (N,) f32: ``q`` = int8 of ``round(x / scale)``
    clipped to +-127 where ``|x| >= thresh``, else 0; returns
    ``(q, x - q * scale)``.  ``thresh``/``scale`` are floats or 0-d
    tensors on x's device."""
    if not use_kernel(x):
        return ref.reference_topk_quant_encode(x, thresh, scale)
    from ._build import lib
    n = x.numel()
    check_cuda_tensor(x, "x", torch.float32, n)
    t, s = _scalar_on(thresh, x), _scalar_on(scale, x)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    r = torch.empty(n, dtype=torch.float32, device=x.device)
    status = lib().topk_quant_encode_launch(
        x.data_ptr(), t.data_ptr(), s.data_ptr(), q.data_ptr(), r.data_ptr(),
        n, torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "topk_quant_encode")
    LAUNCHES["encode"] += 1
    return q, r


def dequant_add(q: torch.Tensor, scale: Scalar, base: torch.Tensor
                ) -> torch.Tensor:
    """One pass: ``base + q * scale`` with q (N,) int8 and base (N,) f32;
    returns a new vector."""
    if not use_kernel(q, base):
        return ref.reference_dequant_add(q, scale, base)
    from ._build import lib
    n = base.numel()
    check_cuda_tensor(q, "q", torch.int8, n)
    check_cuda_tensor(base, "base", torch.float32, n)
    s = _scalar_on(scale, base)
    out = torch.empty(n, dtype=torch.float32, device=base.device)
    status = lib().dequant_add_launch(
        q.data_ptr(), s.data_ptr(), base.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(base.device).cuda_stream)
    check_status(status, "dequant_add")
    LAUNCHES["decode"] += 1
    return out
