"""Forward flash attention for prefill (causal / sliding-window / gemma2
logit-softcap, GQA).

``flash_attention`` replaces the TPU kernel of
``repro/kernels/flash_attention.py::flash_attention``.  On a CUDA tensor it
launches ``csrc/flash_attention.cu``: its tensor-core body for bf16 at
head dims 64, 112, 128 and 256, its SIMT f32 body otherwise (the source
picks by dtype and head_dim).  On a CPU tensor it runs the plain version
``ref.reference_flash_attention``.  See the CUDA source for the design and
its bound.

``flash_attention`` is forward only, as in the JAX package (which has no
backward for its Pallas kernel): on an input that requires grad while
autograd records, it raises rather than return an output with no gradient
path.

``flash_attention_train`` is the training pair, which replaces no TPU
kernel: causal attention as a ``torch.autograd.Function`` whose forward
and backward are kernels of the same source (bf16 at head dims 64 and
128, S a multiple of 64), P rounded to bf16 once as ``mha_chunked`` rounds
it, dS kept to f32 accuracy as two bf16 terms.  The model's "xla" route
takes it where ``models.attention.fused_route`` holds; on CPU tensors it
runs the plain versions ``ref.reference_flash_train_fwd`` and
``ref.reference_flash_train_bwd``.
"""
from __future__ import annotations

import math

import torch

from . import check_status, no_grad_inputs, ref, use_kernel

# kernel launches: a run shows it went through the kernel; "flash" counts
# every launch of the forward-only kernel, "flash_wgmma" those of its
# tensor-core body (bf16 at head dims 64, 112, 128 and 256), so a run also
# shows which body ran; "flash_train_fwd" and "flash_train_bwd" count the
# training pair's launches (a forward call is one, a backward call two:
# dQ, then dK and dV)
LAUNCHES = {"flash": 0, "flash_wgmma": 0, "flash_train_fwd": 0,
            "flash_train_bwd": 0}

# the kernel's head dims: 112 is zamba2-7b's (3584 / 32), on the
# tensor-core body in bf16 (its second 64-column chunk zero-padded)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# the training pair's head dims, and the tile S must be a multiple of
TRAIN_HEAD_DIMS = (64, 128)
TRAIN_TILE = ref.TRAIN_TILE
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B,S,H,D), (B,T,Kv,D), (B,T,Kv,D)")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[1] != S:
        raise ValueError(f"prefill only: T ({k.shape[1]}) must equal S ({S})")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"H ({H}) must be a multiple of Kv ({k.shape[2]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window ({window}) and softcap ({softcap}) must "
                         f"be >= 0 (0 = off)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,Kv,D) with H % Kv == 0, f32 or bf16.
    Returns (B,S,H,D) in q's dtype.  Query head h reads KV head
    ``h // (H // Kv)``; positions run from 0.  Unlike the TPU kernel, S
    need not be a multiple of a tile.  The kernel takes head_dim in
    ``HEAD_DIMS``, which holds every full-size config's head_dim (zamba2-7b's
    112 included); the plain version takes any.  Raises on an input that
    requires grad while autograd records (see the module's docstring)."""
    _check(q, k, v, window, softcap)
    no_grad_inputs("flash_attention", q, k, v)
    if not use_kernel(q, k, v):
        return ref.reference_flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap)
    from ._build import lib
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {HEAD_DIMS}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    wgmma = bool(lib().flash_attention_wgmma_body(_DTYPES[q.dtype], D))
    if wgmma:
        # TMA reads strides and base addresses in multiples of 16 bytes
        q, k, v = (t if _tma_ready(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, k.shape[1], H, k.shape[2], D,
        *(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)),
        int(bool(causal)), int(window), 1.0 / math.sqrt(D), float(softcap),
        _DTYPES[q.dtype], stream)
    check_status(status, "flash_attention")
    LAUNCHES["flash"] += 1
    LAUNCHES["flash_wgmma"] += wgmma
    return out


def _tma_ready(t: torch.Tensor) -> bool:
    """Strides and base address in multiples of 16 bytes."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) > 0 and t.stride(i) % step == 0
                    for i in range(3)))


def training_shape(dtype: torch.dtype, q_shape, k_shape, v_shape) -> bool:
    """Whether the training pair takes operands of these dtypes and shapes:
    bf16, (B,S,H,D) and (B,S,Kv,D) with H % Kv == 0, D in
    ``TRAIN_HEAD_DIMS``, S a multiple of ``TRAIN_TILE``."""
    if dtype != torch.bfloat16 or len(q_shape) != 4 or \
            tuple(k_shape) != tuple(v_shape) or len(k_shape) != 4:
        return False
    B, S, H, D = q_shape
    return (S > 0 and S % TRAIN_TILE == 0 and D in TRAIN_HEAD_DIMS
            and tuple(k_shape[:2]) == (B, S) and k_shape[3] == D
            and k_shape[2] >= 1 and H % k_shape[2] == 0)


def _train_fwd(q, k, v):
    if not use_kernel(q, k, v):
        return ref.reference_flash_train_fwd(q, k, v)
    from ._build import lib
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = lib().flash_train_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, H, k.shape[2], D, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_status(status, "flash_train_fwd")
    LAUNCHES["flash_train_fwd"] += 1
    return o, lse


def _train_bwd(q, k, v, o, lse, do):
    if not use_kernel(q, k, v, o, lse, do):
        return ref.reference_flash_train_bwd(q, k, v, o, lse, do)
    from ._build import lib
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dlt = torch.empty_like(lse)
    status = lib().flash_train_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dlt, dq, dk, dv)),
        B, S, H, k.shape[2], D, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_status(status, "flash_train_bwd")
    LAUNCHES["flash_train_bwd"] += 2
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """The training pair under autograd: saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _train_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _train_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Causal attention with a backward, positions from 0: q (B,S,H,D), k
    and v (B,S,Kv,D), bf16; returns (B,S,H,D) bf16.  On the card it takes
    what ``training_shape`` allows and raises otherwise; on the CPU it
    runs the plain versions of the same arithmetic."""
    _check(q, k, v, 0, 0.0)
    if not training_shape(q.dtype, q.shape, k.shape, v.shape):
        raise ValueError(f"the training pair takes bf16 (B,S,H,D) with D in "
                         f"{TRAIN_HEAD_DIMS} and S a multiple of "
                         f"{TRAIN_TILE}; got {q.dtype} {tuple(q.shape)}")
    return _FlashTrain.apply(q, k, v)
