"""RWKV-6 "Finch" block [arXiv:2404.05892] (port of
``repro/models/rwkv6.py``): token shift with data-dependent lerp (ddlerp),
per-channel data-dependent decay, and the WKV linear-attention recurrence,
chunk-parallel for prefill (``wkv_chunked``) and one O(1)-state step for
decode (``wkv_step``).

Plain PyTorch in the JAX package's layouts and dtypes: the big streams stay
in bf16, f32 only inside a chunk and for the decay and the WKV state.  JAX
rounds its bf16 activations op by op; ``jax.nn.sigmoid`` is spelled as it
computes it (``sigmoid``), ``jax.nn.silu`` through ``layers.silu``.
Prefill's recurrence is kernel B9 in its state form
(``kernels.rwkv6_kernel.wkv_state``, the same chunk step as
``wkv_chunked``) on a CUDA tensor, and the plain ``wkv_chunked`` on a CPU
tensor; decode runs ``wkv_step`` on both, as JAX's does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import rwkv6_kernel
from .layers import COMPUTE_DTYPE, silu

LORA_MIX = 32
LORA_DECAY = 64


def rwkv6_init(generator: torch.Generator, d_model: int, d_ff: int,
               n_heads: int, head_dim: int, lead: tuple = (), device=None):
    """One block's parameters (stacked on ``lead`` axes), bf16, drawn as the
    JAX package draws them: dense weights ``normal / sqrt(fan_in)``, the
    LoRA factors scaled by 0.1, the lerp weights 0.5, ``decay_base`` -4,
    the bonus 0.5 and ``ln_x`` 1."""
    d = d_model

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=COMPUTE_DTYPE,
                          device=device)

    def dense(shape, fan_in, scale=1.0):
        # scaled in f32, then cast once, as JAX casts its f32 tree
        w = torch.randn(lead + shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (w / math.sqrt(fan_in) * scale).to(device=device,
                                                  dtype=COMPUTE_DTYPE)

    return {
        "tm": {
            "mu_base": full((d,), 0.5),
            "mu": full((5, d), 0.5),
            "mix_w1": dense((d, 5, LORA_MIX), d, 0.1),
            "mix_w2": dense((5, LORA_MIX, d), LORA_MIX, 0.1),
            "wr": dense((d, d), d),
            "wk": dense((d, d), d),
            "wv": dense((d, d), d),
            "wg": dense((d, d), d),
            "wo": dense((d, d), d),
            "decay_base": full((d,), -4.0),
            "decay_w1": dense((d, LORA_DECAY), d, 0.1),
            "decay_w2": dense((LORA_DECAY, d), LORA_DECAY, 0.1),
            "bonus": full((n_heads, head_dim), 0.5),
            "ln_x": full((d,), 1.0),
        },
        "cm": {
            "mu_k": full((d,), 0.5),
            "mu_r": full((d,), 0.5),
            "wk": dense((d, d_ff), d),
            "wv": dense((d_ff, d), d_ff),
            "wr": dense((d, d), d),
        },
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, op for op in x's dtype
    (``torch.sigmoid`` rounds once and differs in about a third of bf16
    outputs)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


def _token_shift(x: torch.Tensor, shift_state: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x: (B,S,D); shift_state: (B,1,D) or None (zeros) -> the previous
    token's activations."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, :1])
    return torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 64):
    """WKV recurrence, chunk-parallel (a Python loop over the chunks in
    place of ``lax.scan``).

    r, k, v: (B,S,H,K); w: per-channel decay in (0,1), same shape; u: (H,K);
    s0: (B,H,K,K) f32 or None (zeros).
    y_t = sum_{i<t} [r_t . prod_{j=i+1}^{t-1} w_j . k_i] v_i
          + [r_t . (u * k_t)] v_t   (+ carry from previous chunks)
    Returns (y in r's dtype, final state (B,H,K,K) f32).  Each chunk is
    widened to f32 on its own; the streams stay in their dtype.
    """
    B, S, H, K = r.shape
    C = min(chunk, S)
    assert S % C == 0, (S, C)
    f32 = torch.float32
    out_dt = r.dtype
    lw = torch.log(torch.clamp(w.to(f32), 1e-12, 1.0))
    state = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
             if s0 is None else s0.to(f32))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)[:, :, None]                   # i < t
    uf = u.to(f32)
    ys = []
    for c0 in range(0, S, C):
        rb, kb, vb, lwb = (t[:, c0:c0 + C].transpose(1, 2).to(f32)
                           for t in (r, k, v, lw))              # (B,H,C,K)
        A = torch.cumsum(lwb, dim=2) - lwb                      # exclusive
        Atot = A[:, :, -1] + lwb[:, :, -1]                      # (B,H,K)
        # intra-chunk: decay(i -> t) = exp(A_t - A_i - lw_i), i < t
        D = A[:, :, :, None, :] - A[:, :, None, :, :] - lwb[:, :, None, :, :]
        D = torch.where(tri, D, -torch.inf)
        scores = torch.einsum("bhtk,bhtik,bhik->bhti", rb, torch.exp(D), kb)
        diag = torch.einsum("bhtk,hk,bhtk->bht", rb, uf, kb)    # bonus
        y = scores @ vb + diag[..., None] * vb
        # inter-chunk: read the previous state, then update it
        y = y + (rb * torch.exp(A)) @ state
        kdec = kb * torch.exp(Atot[:, :, None, :] - A - lwb)
        state = state * torch.exp(Atot)[..., None] + \
            kdec.transpose(2, 3) @ vb
        ys.append(y.to(out_dt).transpose(1, 2))
    return torch.cat(ys, dim=1), state


def wkv_step(r, k, v, w, u, state):
    """One decode step.  r, k, v, w: (B,H,K); state: (B,H,K,V) f32.
    Returns (y (B,H,V) f32, new state)."""
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r,
                     state + u.to(f32)[None, :, :, None] * kv)
    return y, state * w[..., None] + kv


def _ddlerp(tm, x, xx):
    """Data-dependent token-shift mixing -> the 5 mixed streams (r, k, v,
    w, g), in x's dtype."""
    dt = x.dtype
    delta = xx - x
    base = x + delta * tm["mu_base"].to(dt)
    lora = torch.tanh(torch.einsum("bsd,dfl->bsfl", base,
                                   tm["mix_w1"].to(dt)))
    adj = torch.einsum("bsfl,fld->bsfd", lora, tm["mix_w2"].to(dt))
    mixed = x[:, :, None, :] + delta[:, :, None, :] * \
        (tm["mu"].to(dt)[None, None] + adj)
    return [mixed[:, :, i, :] for i in range(5)]


def _streams(tm, x, n_heads: int, head_dim: int, shift=None):
    """time_mix's inputs to the recurrence: r, k, v (B,S,H,K) in x's dtype,
    the decay w (B,S,H,K) f32 and the gate g (B,S,D)."""
    dt = x.dtype
    B, S, D = x.shape
    xr, xk, xv, xw, xg = _ddlerp(tm, x, _token_shift(x, shift))
    r = (xr @ tm["wr"].to(dt)).reshape(B, S, n_heads, head_dim)
    k = (xk @ tm["wk"].to(dt)).reshape(B, S, n_heads, head_dim)
    v = (xv @ tm["wv"].to(dt)).reshape(B, S, n_heads, head_dim)
    g = silu(xg @ tm["wg"].to(dt))
    # f32 base plus the bf16 LoRA term, cast after its bf16 product
    dec = tm["decay_base"].to(torch.float32) + \
        (torch.tanh(xw @ tm["decay_w1"].to(dt)) @ tm["decay_w2"].to(dt)
         ).to(torch.float32)
    w = torch.exp(-torch.exp(dec)).reshape(B, S, n_heads, head_dim)
    return r, k, v, w, g


def time_mix(tm, x, n_heads: int, head_dim: int, state=None,
             chunk: int = 64):
    """state: None (train / prefill from zeros) or dict(shift: (B,1,D),
    wkv: (B,H,K,K)).  Returns (out (B,S,D), new state); the new shift is
    the last row of this (normed) input."""
    dt = x.dtype
    B, S, D = x.shape
    shift = state["shift"] if state is not None else None
    r, k, v, w, g = _streams(tm, x, n_heads, head_dim, shift)
    if state is not None and S == 1:
        y, wkv = wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], tm["bonus"],
                          state["wkv"])
        y = y[:, None]
        new_state = {"shift": x, "wkv": wkv}
    else:
        s0 = state["wkv"] if state is not None else None
        recurrence = (wkv_chunked if r.device.type == "cpu"
                      else rwkv6_kernel.wkv_state)
        y, wkv = recurrence(r, k, v, w, tm["bonus"], s0, chunk=chunk)
        new_state = {"shift": x[:, -1:], "wkv": wkv}
    # per-head group norm (population variance, as jnp.var)
    y = y.to(torch.float32)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, D) * tm["ln_x"].to(torch.float32)
    out = (y.to(dt) * g) @ tm["wo"].to(dt)
    return out, new_state


def channel_mix(cm, x, state=None):
    """state: None or dict(shift: (B,1,D)).  Returns (out, new state)."""
    dt = x.dtype
    shift = state["shift"] if state is not None else None
    xx = _token_shift(x, shift)
    xk = x + (xx - x) * cm["mu_k"].to(dt)
    xr = x + (xx - x) * cm["mu_r"].to(dt)
    k = torch.square(torch.relu(xk @ cm["wk"].to(dt)))
    out = sigmoid(xr @ cm["wr"].to(dt)) * (k @ cm["wv"].to(dt))
    return out, {"shift": x[:, -1:]}
