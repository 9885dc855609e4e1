"""Attention: GQA with RoPE, sliding windows, gemma2 logit soft-capping
(port of ``repro/models/attention.py``).

Three execution paths, selected as in the JAX package:
  * ``mha_chunked`` — blockwise attention with an online softmax in plain
    PyTorch, the counterpart of ``attn_impl="xla"``.  Block bounds are
    static per query block, so causal and window structure skips KV
    blocks.  The training path: plain ops, so autograd differentiates it
    (with ``cfg.remat`` the model recomputes each block in backward).
  * ``decode_attention`` — one token over a (ring-buffered) KV cache.
  * the flash-attention kernel B8 (``repro_torch.kernels.flash_attention``)
    for ``attn_impl="pallas"`` or ``"pallas_interpret"``: a CUDA tensor
    launches the kernel, a CPU tensor runs its plain version.

Weights stay 3-D ``(d_model, heads, head_dim)``, the JAX package's layout.
Scores are f32: a bf16 product is computed as the f32 product of its
exactly converted operands, JAX's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import NEG_INF, attention_mask

from .layers import apply_rope, dense_init


def attn_init(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv: int, head_dim: int, *, lead=(), device=None):
    """q/k/v/o projections (bf16), each ``normal / sqrt(fan_in)``; ``lead``
    prepends stacking axes (blocks, or gemma2's pairs)."""
    lead = tuple(lead)
    return {
        "wq": dense_init(generator, lead + (d_model, n_heads, head_dim),
                         d_model, device),
        "wk": dense_init(generator, lead + (d_model, n_kv, head_dim),
                         d_model, device),
        "wv": dense_init(generator, lead + (d_model, n_kv, head_dim),
                         d_model, device),
        "wo": dense_init(generator, lead + (n_heads, head_dim, d_model),
                         head_dim, device),
    }


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,Kv,hd) -> (B,T,H,hd), each KV head repeated H/Kv times (head h
    reads KV head h // (H/Kv))."""
    B, T, Kv, hd = k.shape
    if Kv == n_heads:
        return k
    rep = n_heads // Kv
    return k[:, :, :, None, :].expand(B, T, Kv, rep, hd).reshape(
        B, T, n_heads, hd)


def naive_attention(q, k, v, *, causal=True, window=0, softcap_val=0.0,
                    q_offset=0):
    """O(S^2)-memory reference. q: (B,S,H,hd); k, v: (B,T,Kv,hd).  P is
    cast to v's dtype before PV, as in the JAX package."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    s = torch.where(attention_mask(qpos, kpos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha_chunked(q, k, v, *, causal=True, window=0, softcap_val=0.0,
                q_block=512, kv_block=512, q_offset=0):
    """Blockwise attention with an online softmax; never materialises the
    (S, T) scores.  A loop over query blocks, and for each a loop over the
    KV blocks its band needs.  GQA groups the query heads of one KV head
    instead of repeating K and V.  P is cast to v's dtype before PV (the
    flash kernel keeps it in f32)."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    q_block = min(q_block, S)
    kv_block = min(kv_block, T)
    if S % q_block or T % kv_block:
        raise ValueError(f"S={S}, T={T} must be multiples of the blocks "
                         f"({q_block}, {kv_block})")
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    out_blocks = []
    for qs in range(0, S, q_block):
        q_abs_lo, q_abs_hi = q_offset + qs, q_offset + qs + q_block
        lo, hi = 0, T
        if causal:
            hi = min(T, q_abs_hi)
        if window:
            lo = max(0, q_abs_lo - window + 1)
        lo = (lo // kv_block) * kv_block
        hi = min(-(-hi // kv_block) * kv_block, T)
        qb = q[:, qs:qs + q_block].float().reshape(B, q_block, Kv, rep, hd)
        qpos = torch.arange(q_abs_lo, q_abs_hi, device=q.device)
        m = torch.full((B, Kv, rep, q_block), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros((B, Kv, rep, q_block), dtype=f32, device=q.device)
        acc = torch.zeros((B, Kv, rep, q_block, hd), dtype=f32,
                          device=q.device)
        for start in range(lo, hi, kv_block):
            kb = k[:, start:start + kv_block]
            vb = v[:, start:start + kv_block]
            kpos = torch.arange(start, start + kv_block, device=q.device)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float()) * scale
            if softcap_val:
                s = softcap_val * torch.tanh(s / softcap_val)
            s = torch.where(attention_mask(qpos, kpos, causal, window), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        ob = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,Kv,rep,qb,hd)
        out_blocks.append(ob.permute(0, 3, 1, 2, 4).reshape(B, q_block, H,
                                                             hd))
    return torch.cat(out_blocks, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (ring buffers for sliding-window archs)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None):
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        # global position held by each slot; -1 = empty
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def cache_write(cache, k_new, v_new, pos: int):
    """Write one step (B,1,Kv,hd) at global position ``pos`` into slot
    ``pos % C``.  Unlike the JAX package's ``dynamic_update_slice``, this
    writes ``cache`` IN PLACE and returns the same dict: a cache (or a
    decode state holding it) is not valid as it was after a step."""
    pos = int(pos)
    idx = pos % cache["k"].shape[1]
    cache["k"][:, idx] = k_new[:, 0]
    cache["v"][:, idx] = v_new[:, 0]
    cache["slot_pos"][idx] = pos
    return cache


def decode_attention(q, cache, *, window=0, softcap_val=0.0, cur_pos=None):
    """q: (B,1,H,hd) attends over the cache.  The mask comes from the slot
    positions, so the same code serves full caches and ring buffers."""
    B, S1, H, hd = q.shape
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    C, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    qg = q.float().reshape(B, S1, Kv, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) / math.sqrt(hd)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    valid = slot_pos >= 0
    if cur_pos is not None:
        valid &= slot_pos <= cur_pos
        if window:
            valid &= (cur_pos - slot_pos) < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S1, H, hd).to(v.dtype)


# ---------------------------------------------------------------------------
# Full attention block application
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,heads,hd) -> (B,S,heads,hd) in x's dtype."""
    D, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, n * hd)).reshape(
        *x.shape[:-1], n, hd)


def attn_apply(params, x, *, cfg, window: int = 0, rope_theta=None,
               cache=None, cur_pos: Optional[int] = None,
               impl: Optional[str] = None):
    """x: (B,S,D).  With ``cache``, one decode step that writes the cache
    in place: returns (out, cache).  Else train/prefill: returns (out,
    (k, v)).  ``window``: 0 = full attention (callers resolve gemma2's
    local/global layers)."""
    dt = x.dtype
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    B, S, D = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    wo = params["wo"].to(dt)
    wo = wo.reshape(wo.shape[0] * wo.shape[1], wo.shape[2])

    if cache is not None:
        pos = torch.full((B, S), int(cur_pos), device=x.device)
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
        cache = cache_write(cache, k, v, cur_pos)
        out = decode_attention(q, cache, window=window,
                               softcap_val=cfg.attn_softcap, cur_pos=cur_pos)
        return out.to(dt).reshape(B, S, -1) @ wo, cache

    pos = torch.arange(S, device=x.device).expand(B, S)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    impl = impl or cfg.attn_impl
    if impl == "xla":
        out = mha_chunked(q, k, v, causal=True, window=window,
                          softcap_val=cfg.attn_softcap)
    elif impl in ("pallas", "pallas_interpret"):
        out = fa.flash_attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_softcap)
    else:
        raise ValueError(impl)
    return out.to(dt).reshape(B, S, -1) @ wo, (k, v)
