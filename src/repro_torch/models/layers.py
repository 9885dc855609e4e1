"""Shared layer primitives of the LM family (port of
``repro/models/layers.py``): soft-capping, RMSNorm, rotary embeddings, GLU
MLPs and the token embedding.

Plain functions over dicts of tensors, in the JAX package's layouts and
dtypes: parameters live in bf16 (``COMPUTE_DTYPE``), norms and rotary
angles are computed in f32 and cast back.  The chunked vocabulary loss is
training and is not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

from repro_torch import resolve_device

COMPUTE_DTYPE = torch.bfloat16


def dense_init(generator: torch.Generator, shape, fan_in: int,
               device=None) -> torch.Tensor:
    """f32 ``normal / sqrt(fan_in)`` drawn on the generator's device, then
    cast to bf16 on ``device`` (the JAX package draws f32 master weights
    and casts the whole tree to bf16)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) / math.sqrt(fan_in)
    return w.to(device=device, dtype=COMPUTE_DTYPE)


def rmsnorm_init(d: int, device=None) -> dict:
    """RMSNorm's parameters in the ``(1 + scale)`` form: ``scale`` zeros,
    in bf16 (the JAX package's f32 zeros as its tree is cast)."""
    return {"scale": torch.zeros((d,), dtype=COMPUTE_DTYPE,
                                 device=resolve_device(device))}


def glu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                 device=None) -> dict:
    """A GLU MLP's three projections, each ``normal / sqrt(fan_in)``."""
    device = resolve_device(device)
    return {"wi_gate": dense_init(generator, (d_model, d_ff), d_model, device),
            "wi_up": dense_init(generator, (d_model, d_ff), d_model, device),
            "wo": dense_init(generator, (d_ff, d_model), d_ff, device)}


def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               device=None) -> dict:
    """The token embedding, ``normal * 0.02``, drawn in f32 on the
    generator's device and cast to bf16 on ``device``."""
    e = torch.randn((vocab, d_model), generator=generator,
                    dtype=torch.float32, device=generator.device) * 0.02
    return {"embedding": e.to(device=resolve_device(device),
                              dtype=COMPUTE_DTYPE)}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), in ``x``'s dtype."""
    return (cap * torch.tanh(x / cap)).to(x.dtype)


def rmsnorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the ``(1 + scale)`` form, computed in f32."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + params["scale"].float())
    return y.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the two halves of the head dimension by f32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs        # (..,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``, op for op in x's dtype
    (``F.silu`` rounds once and differs in about 40% of bf16 outputs)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, op for op in x's dtype, with
    ``sqrt(2/pi)`` rounded to that dtype as JAX rounds it (``F.gelu``
    differs in about 45% of bf16 outputs)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                     device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def glu_mlp(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            act: str = "silu") -> torch.Tensor:
    """Gated MLP: ``(act(x @ wi_gate) * (x @ wi_up)) @ wo`` in x's dtype;
    ``act`` is ``silu`` or ``gelu`` (tanh approximation)."""
    dt = x.dtype
    gate = x @ params["wi_gate"].to(dt)
    up = x @ params["wi_up"].to(dt)
    if act == "silu":
        h = silu(gate) * up
    elif act == "gelu":
        h = gelu_tanh(gate) * up
    else:
        raise ValueError(act)
    return h @ params["wo"].to(dt)


def embed(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    """Token embedding in bf16; gemma scales it by ``sqrt(d_model)``
    (rounded to bf16, as in the JAX package)."""
    e = params["embedding"].to(COMPUTE_DTYPE)[tokens.long()]
    if scale:
        e = e * torch.tensor(math.sqrt(e.shape[-1]), dtype=e.dtype,
                             device=e.device)
    return e
