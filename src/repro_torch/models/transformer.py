"""The LM serving path for attention-block models without experts and for
rwkv6 (port of ``repro/models/transformer.py``): parameters, ``forward``,
``prefill_step`` and ``serve_step``.

The JAX package's layout is kept, so ``params_from_numpy`` is a straight
map: blocks stacked on a leading axis (``(L, ...)``), gemma2's
local/global alternation as pairs (``(L/2, 2, ...)``), 3-D attention
projections, bf16 everywhere.  A Python loop over the stacked blocks takes
the place of ``lax.scan``; for gemma2 each pair runs its local (window)
layer, then its global layer.

A decode step writes its state IN PLACE (the KV caches through
``attention.cache_write``; rwkv6's shift and WKV states by copy) and
returns that same state.

Not ported yet (ROADMAP A5), each raising ``NotImplementedError``: the
mamba2 block type and mixture-of-experts configs.  The loss and
``train_step`` are training and wait for a later slice.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device

from . import attention as attn_mod
from . import rwkv6 as rwkv_mod
from .layers import (COMPUTE_DTYPE, dense_init, embed, glu_mlp, rmsnorm,
                     softcap)


def _check_supported(cfg) -> None:
    if cfg.block_type not in ("attn", "rwkv6"):
        raise NotImplementedError(
            f"{cfg.name}: block_type {cfg.block_type!r} is not ported to "
            f"repro_torch yet (ROADMAP A5)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts blocks are not ported to "
            f"repro_torch yet (ROADMAP A5)")


def _lead(cfg) -> tuple:
    """Stacking axes of the blocks: (L/2, 2) for gemma2's pairs, else (L,)."""
    if cfg.alt_local_global:
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: alt_local_global needs an even "
                             f"n_layers, got {cfg.n_layers}")
        return (cfg.n_layers // 2, 2)
    return (cfg.n_layers,)


def _block_indices(cfg):
    """(index into the stacked blocks, window) in the order they run."""
    if cfg.alt_local_global:
        return [((i, j), cfg.window if j == 0 else 0)
                for i in range(cfg.n_layers // 2) for j in (0, 1)]
    return [((i,), cfg.window) for i in range(cfg.n_layers)]


def _index(tree, idx):
    return {k: _index(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device=None):
    """Random bf16 parameters, drawn from ``generator`` (on any device):
    dense weights f32 ``normal / sqrt(fan_in)``, the embedding ``normal *
    0.02``, norm scales 0 (the ``1 + scale`` form), as the JAX package
    initialises them.  torch cannot replay ``jax.random``: for parity runs
    convert the JAX package's parameters with ``params_from_numpy``."""
    _check_supported(cfg)
    device = resolve_device(device)
    lead = _lead(cfg)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)

    blocks = {"ln1": {"scale": zeros(*lead, d)},
              "ln2": {"scale": zeros(*lead, d)}}
    if cfg.block_type == "rwkv6":
        blocks["rwkv"] = rwkv_mod.rwkv6_init(
            generator, d, cfg.d_ff, cfg.n_heads, cfg.ssm_head_dim, lead=lead,
            device=device)
    else:
        blocks["attn"] = attn_mod.attn_init(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, lead=lead,
            device=device)
        blocks["mlp"] = {
            "wi_gate": dense_init(generator, lead + (d, cfg.d_ff), d, device),
            "wi_up": dense_init(generator, lead + (d, cfg.d_ff), d, device),
            "wo": dense_init(generator, lead + (cfg.d_ff, d), cfg.d_ff,
                             device),
        }
    if cfg.post_block_norm:
        blocks["post_ln1"] = {"scale": zeros(*lead, d)}
        blocks["post_ln2"] = {"scale": zeros(*lead, d)}
    emb = torch.randn((cfg.vocab_size, d), generator=generator,
                      dtype=torch.float32, device=generator.device) * 0.02
    return {"embed": {"embedding": emb.to(device=device, dtype=COMPUTE_DTYPE)},
            "final_norm": {"scale": zeros(d)},
            "blocks": blocks}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX exports
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(COMPUTE_DTYPE)
    return t.to(device)


def params_from_numpy(tree: Mapping, device=None):
    """The JAX package's parameters, exported as (nested dicts of) numpy
    arrays, as the port's parameters on ``device``: the same keys and
    shapes, floating arrays in bf16."""
    device = resolve_device(device)
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else _tensor(v, device) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks and caches
# ---------------------------------------------------------------------------

def _attn_block_apply(p, x, cfg, *, window, cache=None, cur_pos=None):
    """One pre-norm attention block (gemma2 adds the sandwich norms and the
    gelu GLU).  Returns (x, kv): kv is (k, v) in prefill, the updated cache
    in decode."""
    h = rmsnorm(p["ln1"], x)
    a, kv = attn_mod.attn_apply(p["attn"], h, cfg=cfg, window=window,
                                cache=cache, cur_pos=cur_pos)
    if cfg.post_block_norm:
        a = rmsnorm(p["post_ln1"], a)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    act = "gelu" if cfg.post_block_norm else "silu"
    f = glu_mlp(p["mlp"], h, act=act)
    if cfg.post_block_norm:
        f = rmsnorm(p["post_ln2"], f)
    return x + f, kv


def _rwkv_block_apply(p, x, cfg, state=None):
    """One rwkv6 block: time mix and channel mix, each on its own pre-norm.
    Returns (x, the block's new state)."""
    st_tm = state["tm"] if state is not None else None
    a, new_tm = rwkv_mod.time_mix(p["rwkv"]["tm"], rmsnorm(p["ln1"], x),
                                  cfg.n_heads, cfg.ssm_head_dim, st_tm)
    x = x + a
    st_cm = state["cm"] if state is not None else None
    f, new_cm = rwkv_mod.channel_mix(p["rwkv"]["cm"], rmsnorm(p["ln2"], x),
                                     st_cm)
    return x + f, {"tm": new_tm, "cm": new_cm}


def _kv_from_full(k, v, cache_len: int):
    """Full-sequence K/V (B,S,Kv,hd) as a decode cache of ``cache_len``
    slots: ring layout when cache_len < S (slot = pos % C), zero headroom
    with ``slot_pos = -1`` when cache_len > S."""
    S = k.shape[1]
    dev = k.device
    if cache_len < S:
        return {"k": k[:, -cache_len:], "v": v[:, -cache_len:],
                "slot_pos": torch.arange(S - cache_len, S, dtype=torch.int32,
                                         device=dev)}
    if cache_len > S:
        pad = cache_len - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        slot_pos = torch.cat([
            torch.arange(S, dtype=torch.int32, device=dev),
            torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        return {"k": k, "v": v, "slot_pos": slot_pos}
    return {"k": k, "v": v,
            "slot_pos": torch.arange(S, dtype=torch.int32, device=dev)}


def init_decode_state(cfg, batch: int, context_len: int,
                      dtype=COMPUTE_DTYPE, device=None):
    """Zeroed decode state, stacked like the blocks: ``{"kv": {"k", "v",
    "slot_pos"}}``, each cache ``cfg.kv_cache_len(context_len)`` slots; for
    rwkv6 ``{"tm": {"shift", "wkv"}, "cm": {"shift"}}`` (the WKV state in
    f32, ``context_len`` unused)."""
    _check_supported(cfg)
    device = resolve_device(device)
    if cfg.block_type == "rwkv6":
        L, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.ssm_head_dim

        def shift():
            return torch.zeros((L, batch, 1, D), dtype=dtype, device=device)
        return {"tm": {"shift": shift(),
                       "wkv": torch.zeros((L, batch, H, K, K),
                                          dtype=torch.float32,
                                          device=device)},
                "cm": {"shift": shift()}}
    C = cfg.kv_cache_len(context_len)
    lead = _lead(cfg)
    shape = lead + (batch, C, cfg.n_kv_heads, cfg.hd)
    return {"kv": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.zeros(lead + (C,), dtype=torch.int32,
                                device=device)}}


# ---------------------------------------------------------------------------
# Forward and steps
# ---------------------------------------------------------------------------

def forward(params, cfg, *, tokens=None, embeds=None, state=None,
            cur_pos: Optional[int] = None, return_cache=False,
            cache_len: Optional[int] = None):
    """Returns (hidden (B,S,D), aux_loss (0: no experts), state or None).

    * train:    state=None, return_cache=False
    * prefill:  state=None, return_cache=True  (decode state built from K/V)
    * decode:   state=<decode state>, S == 1; the state is updated in place

    rwkv6 prefills from a zero state; ``cur_pos`` is not used there.
    """
    _check_supported(cfg)
    dev = params["embed"]["embedding"].device
    if embeds is not None:
        x = torch.as_tensor(embeds, device=dev).to(COMPUTE_DTYPE)
    else:
        x = embed(params["embed"], torch.as_tensor(tokens, device=dev),
                  scale=cfg.post_block_norm)
    B, S, _ = x.shape
    decode = state is not None
    new_state = None
    if decode:
        new_state = state
    elif return_cache:
        C = cache_len or cfg.kv_cache_len(S)
        new_state = init_decode_state(cfg, B, C, dtype=x.dtype, device=dev)
    if cfg.block_type == "rwkv6":
        for i in range(cfg.n_layers):
            x, st = _rwkv_block_apply(_index(params["blocks"], i), x, cfg,
                                      _index(state, i) if decode else None)
            if new_state is not None:
                _copy_into(new_state, st, i)
    else:
        for idx, window in _block_indices(cfg):
            cache = _index(state["kv"], idx) if decode else None
            x, kv = _attn_block_apply(_index(params["blocks"], idx), x, cfg,
                                      window=window, cache=cache,
                                      cur_pos=cur_pos)
            if return_cache and not decode:
                for name, t in _kv_from_full(*kv, C).items():
                    new_state["kv"][name][idx].copy_(t)
    x = rmsnorm(params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=dev), new_state


def _copy_into(stacked, tree, i) -> None:
    """Write ``tree``'s tensors into entry ``i`` of the stacked ``stacked``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def logits_from_hidden(params, cfg, h):
    table = params["embed"]["embedding"].to(h.dtype)
    logits = h @ table.T
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def prefill_step(params, batch, *, cfg, max_len: Optional[int] = None):
    """``max_len``: the whole decode horizon — the returned cache has room
    for (max_len - S) further tokens (ring-capped for windowed archs).
    Returns (last-token logits (B,1,V), decode state)."""
    cache_len = cfg.kv_cache_len(max_len) if max_len else None
    h, _, state = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), return_cache=True,
                          cache_len=cache_len)
    return logits_from_hidden(params, cfg, h[:, -1:]), state


def serve_step(params, state, tokens, cur_pos: int, *, cfg, embeds=None):
    """One decode step: tokens (B,1) (or embeds (B,1,D)) at position
    ``cur_pos``.  Returns (logits (B,1,V), state); ``state`` is the one
    passed in, written in place."""
    h, _, state = forward(params, cfg, tokens=tokens, embeds=embeds,
                          state=state, cur_pos=cur_pos)
    return logits_from_hidden(params, cfg, h), state
