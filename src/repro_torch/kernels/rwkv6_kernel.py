"""The RWKV-6 WKV recurrence, chunk-parallel, from an initial state.

``wkv`` replaces the TPU kernel of
``repro/kernels/rwkv6_kernel.py::wkv_pallas`` (y only, from a zero state);
``wkv_state`` is the same kernel in the form of the model's
``wkv_chunked``, from a given state and returning the final one.  On a
CUDA tensor both launch ``csrc/wkv.cu``; on a CPU tensor they run the
plain version ``ref.reference_wkv_chunked``.  See the CUDA source for the
design and its bound.

Forward only, as in the JAX package: both raise on an input that requires
grad while autograd records (``kernels.no_grad_inputs``); the model trains
through the plain ``wkv_chunked``, as JAX's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import check_status, no_grad_inputs, ref, use_kernel

# kernel launches, one a call: a run shows it went through the kernel
LAUNCHES = {"wkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 64


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B,S,H,K), got {tuple(r.shape)}")
    for t, name in ((k, "k"), (v, "v"), (w, "w")):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit r "
                             f"{tuple(r.shape)}")
    B, _, H, K = r.shape
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H,K) = {(H, K)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, K, K):
        raise ValueError(f"s0 must be (B,H,K,K) = {(B, H, K, K)}, got "
                         f"{tuple(s0.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one of {list(_DTYPES)}; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")


def _chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"S ({S}) must be a multiple of the chunk ({chunk})")
    return chunk


def rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B,S,H,K) itself when the kernel can read it in place: unit
    stride along K, every row of K starting on 16 bytes; else a contiguous
    copy."""
    n = t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            t.stride(i) * n % 16 == 0 for i in range(3)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(r, k, v, w, u, s0, chunk: int, with_state: bool):
    """One call of the kernel (its three passes): y, and the final state
    when ``with_state``."""
    from ._build import lib
    B, S, H, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"head size {K}: the kernel takes {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes at most "
                         f"{MAX_CHUNK} positions")
    r, k, v, w = (rows_aligned(t) for t in (r, k, v, w))
    f32 = torch.float32
    uf = u.to(f32).contiguous()
    s0f = None if s0 is None else s0.to(f32).contiguous()
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    state = (torch.empty((B, H, K, K), dtype=f32, device=r.device)
             if with_state else None)
    nc = S // chunk
    ds = torch.empty((B, H, nc, K, K), dtype=f32, device=r.device)
    ea = torch.empty((B, H, nc, K), dtype=f32, device=r.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    status = lib().wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        uf.data_ptr(), ptr(s0f), y.data_ptr(), ptr(state), ds.data_ptr(),
        ea.data_ptr(), B, S, H, K, chunk,
        *(t.stride(i) for t in (r, k, v, w, y) for i in (0, 1, 2)),
        _DTYPES[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    check_status(status, "wkv")
    LAUNCHES["wkv"] += 1
    return y, state


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16) -> torch.Tensor:
    """r, k, v: (B,S,H,K), f32 or bf16; w: per-channel decay in (0, 1),
    same shape (taken in f32); u: (H,K) bonus.  Returns y (B,S,H,K) in r's
    dtype, the recurrence run from a zero state in chunks of
    ``min(chunk, S)`` positions, which must divide S.  The kernel takes K
    in ``HEAD_DIMS`` (rwkv6-3b's is 64) and chunks of at most
    ``MAX_CHUNK``, and reads r, k, v and w through their strides where
    ``rows_aligned`` allows (it copies them otherwise); the plain version
    takes any."""
    _check(r, k, v, w, u, None)
    no_grad_inputs("wkv", r, k, v, w, u)
    chunk = _chunk(r.shape[1], chunk)
    w = w.to(torch.float32)
    if not use_kernel(r, k, v, w, u):
        return ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk)
    return _launch(r, k, v, w, u, None, chunk, False)[0]


def wkv_pallas(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16
               ) -> torch.Tensor:
    """The JAX package's name of ``wkv``: y from a zero state, chunk 16
    (its ``interpret`` knob has no twin: the device picks the path)."""
    return wkv(r, k, v, w, u, chunk=chunk)


def wkv_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None, *, chunk: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv`` from the state ``s0`` (B,H,K,K) (zeros when None), in the
    model's chunk of 64 by default.  Returns (y in r's dtype, the final
    state (B,H,K,K) f32), as ``models.rwkv6.wkv_chunked`` does; the state
    is a new tensor and ``s0`` is only read."""
    _check(r, k, v, w, u, s0)
    no_grad_inputs("wkv_state", r, k, v, w, u, s0)
    chunk = _chunk(r.shape[1], chunk)
    w = w.to(torch.float32)
    tensors = (r, k, v, w, u) if s0 is None else (r, k, v, w, u, s0)
    if not use_kernel(*tensors):
        return ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk, s0=s0,
                                         return_state=True)
    return _launch(r, k, v, w, u, s0, chunk, True)
