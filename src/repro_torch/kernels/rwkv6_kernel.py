"""The RWKV-6 WKV recurrence, chunk-parallel, from a zero state.

``wkv`` replaces the TPU kernel of
``repro/kernels/rwkv6_kernel.py::wkv_pallas``.  On a CUDA tensor it
launches ``csrc/wkv.cu``; on a CPU tensor it runs the plain version
``ref.reference_wkv_chunked``.  See the CUDA source for the design and its
bound.
"""
from __future__ import annotations

import torch

from . import check_status, ref, use_kernel

# kernel launches: a run shows it went through the kernel
LAUNCHES = {"wkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B,S,H,K), got {tuple(r.shape)}")
    for t, name in ((k, "k"), (v, "v"), (w, "w")):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be (H,K) = {tuple(r.shape[2:])}, got "
                         f"{tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one of {list(_DTYPES)}; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16) -> torch.Tensor:
    """r, k, v: (B,S,H,K), f32 or bf16; w: per-channel decay in (0, 1),
    same shape (taken in f32); u: (H,K) bonus.  Returns y (B,S,H,K) in r's
    dtype, the recurrence run from a zero state in chunks of
    ``min(chunk, S)`` positions, which must divide S.  The kernel takes K
    in ``HEAD_DIMS`` (rwkv6-3b's is 64); the plain version any."""
    _check(r, k, v, w, u)
    B, S, H, K = r.shape
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"S ({S}) must be a multiple of the chunk ({chunk})")
    w = w.to(torch.float32)
    if not use_kernel(r, k, v, w, u):
        return ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk)
    from ._build import lib
    if K not in HEAD_DIMS:
        raise ValueError(f"head size {K}: the kernel takes {HEAD_DIMS}")
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the channel dimension must be "
                             f"contiguous")
    uf = u.to(torch.float32).contiguous()
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    status = lib().wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        uf.data_ptr(), y.data_ptr(), B, S, H, K, chunk,
        *(t.stride(i) for t in (r, k, v, w, y) for i in (0, 1, 2)),
        _DTYPES[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    check_status(status, "wkv")
    LAUNCHES["wkv"] += 1
    return y
