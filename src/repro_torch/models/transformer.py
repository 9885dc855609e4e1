"""Model assembly for all six architecture families (port of
``repro/models/transformer.py``): parameters, ``forward``, ``loss_fn``,
``train_step``, ``prefill_step`` and ``serve_step``.

The JAX package's layout is kept, so ``params_from_numpy`` is a straight
map: blocks stacked on a leading axis (``(L, ...)``), gemma2's
local/global alternation as pairs (``(L/2, 2, ...)``), zamba2's mamba2
blocks as groups (``(G, per, ...)``) around one ``shared_attn`` block and
a ``tail``, 3-D attention projections, bf16 everywhere.  A Python loop
over the stacked blocks takes the place of ``lax.scan``; for gemma2 each
pair runs its local (window) layer, then its global layer; for zamba2
each group runs its mamba2 blocks, then the shared attention block (full
attention, ``window=0``).

A decode step writes its state IN PLACE (the KV caches through
``attention.cache_write``; the recurrent states by copy) and returns
that same state.

Training (``loss_fn``, ``train_step``) runs at the configs'
``attn_impl="xla"``, as JAX's does.  There, causal attention on the card
at the shapes the training kernel pair takes (bf16, head dim 64 or 128,
no softcap, no window) runs as that pair, a forward and a backward kernel
under autograd (``attention.fused_route``); other attention runs the
plain ``mha_chunked``.  B8 and B9 are forward only and raise under
autograd (``kernels.no_grad_inputs``); rwkv6's recurrence takes the plain
``wkv_chunked`` whenever autograd records.  With ``cfg.remat`` each block
of a training forward is recomputed in backward
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
# torch imports torch._dynamo lazily inside the first checkpointed call,
# and the import keeps its calling frames alive in a reference cycle: the
# first train_step's gradients would outlive it until the cyclic garbage
# collector runs (2 B a parameter at a pod round's peak).  Imported here,
# outside any step.
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, tracing
from repro_torch.parallel import sharding
from repro_torch.tree import leaves, unflatten

from . import attention as attn_mod
from . import mamba2 as mamba_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import (COMPUTE_DTYPE, chunked_ce_loss, dense_init, embed,
                     glu_mlp, rmsnorm, softcap)


def _check_block_type(cfg) -> None:
    if cfg.block_type not in ("attn", "rwkv6", "mamba2"):
        raise ValueError(cfg.block_type)


def _hybrid_layout(cfg) -> tuple:
    """zamba2: (groups, mamba2 blocks per group, trailing mamba2 blocks)."""
    G = cfg.n_shared_attn_applications()
    per = cfg.shared_attn_every
    return G, per, cfg.n_layers - G * (per + 1)


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

def _zeros(lead, d, device):
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=COMPUTE_DTYPE,
                                 device=device)}


def _attn_blocks_init(generator, cfg, lead, device):
    """Attention blocks (stacked on ``lead``): norms, attention, and the
    GLU MLP or, for MoE configs, the experts."""
    d = cfg.d_model
    blocks = {"ln1": _zeros(lead, d, device), "ln2": _zeros(lead, d, device),
              "attn": attn_mod.attn_init(generator, d, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.hd, lead=lead,
                                         device=device)}
    if cfg.is_moe:
        blocks["moe"] = moe_mod.moe_init(generator, d, cfg.d_ff,
                                         cfg.n_experts, lead=lead,
                                         device=device)
    else:
        blocks["mlp"] = {
            "wi_gate": dense_init(generator, lead + (d, cfg.d_ff), d, device),
            "wi_up": dense_init(generator, lead + (d, cfg.d_ff), d, device),
            "wo": dense_init(generator, lead + (cfg.d_ff, d), cfg.d_ff,
                             device),
        }
    if cfg.post_block_norm:
        blocks["post_ln1"] = _zeros(lead, d, device)
        blocks["post_ln2"] = _zeros(lead, d, device)
    return blocks


def _mamba_blocks_init(generator, cfg, lead, device):
    return {"ln": _zeros(lead, cfg.d_model, device),
            "mamba": mamba_mod.mamba2_init(
                generator, cfg.d_model, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state, lead=lead,
                device=device)}


def init_params(generator: torch.Generator, cfg, device=None):
    """Random bf16 parameters, drawn from ``generator`` (on any device):
    dense weights f32 ``normal / sqrt(fan_in)``, the embedding ``normal *
    0.02``, norm scales 0 (the ``1 + scale`` form), as the JAX package
    initialises them.  torch cannot replay ``jax.random``: for parity runs
    convert the JAX package's parameters with ``params_from_numpy``."""
    _check_block_type(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    if cfg.block_type == "rwkv6":
        lead = _lead(cfg)
        blocks = {"ln1": _zeros(lead, d, device),
                  "ln2": _zeros(lead, d, device),
                  "rwkv": rwkv_mod.rwkv6_init(
                      generator, d, cfg.d_ff, cfg.n_heads, cfg.ssm_head_dim,
                      lead=lead, device=device)}
    elif cfg.block_type == "attn":
        blocks = _attn_blocks_init(generator, cfg, _lead(cfg), device)
    extra = {}
    if cfg.block_type == "mamba2":
        G, per, trailing = _hybrid_layout(cfg)
        blocks = _mamba_blocks_init(generator, cfg, (G, per), device)
        extra["shared_attn"] = _attn_blocks_init(generator, cfg, (), device)
        if trailing:
            extra["tail"] = _mamba_blocks_init(generator, cfg, (trailing,),
                                               device)
    emb = torch.randn((cfg.vocab_size, d), generator=generator,
                      dtype=torch.float32, device=generator.device) * 0.02
    return {"embed": {"embedding": emb.to(device=device, dtype=COMPUTE_DTYPE)},
            "final_norm": {"scale": torch.zeros((d,), dtype=COMPUTE_DTYPE,
                                                device=device)},
            "blocks": blocks, **extra}


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
    shapes (zamba2's ``blocks``, ``shared_attn`` and ``tail`` too),
    floating arrays in bf16."""
    device = resolve_device(device)
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else _tensor(v, device) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks and caches
# ---------------------------------------------------------------------------

def _attn_block_apply(p, x, cfg, *, window, cache=None, cur_pos=None):
    """One pre-norm attention block (gemma2 adds the sandwich norms and the
    gelu GLU; MoE configs run the experts).  Returns (x, aux, kv): aux is
    the MoE aux loss (0 without experts), kv is (k, v) in prefill, the
    updated cache in decode."""
    h = rmsnorm(p["ln1"], x)
    a, kv = attn_mod.attn_apply(p["attn"], h, cfg=cfg, window=window,
                                cache=cache, cur_pos=cur_pos)
    if cfg.post_block_norm:
        a = rmsnorm(p["post_ln1"], a)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    if cfg.is_moe:
        f, aux = moe_mod.moe_apply(p["moe"], h, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
    else:
        act = "gelu" if cfg.post_block_norm else "silu"
        f = glu_mlp(p["mlp"], h, act=act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_block_norm:
        f = rmsnorm(p["post_ln2"], f)
    return x + f, aux, kv


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


def _mamba_block_apply(p, x, cfg, state=None):
    """One pre-norm mamba2 block.  Returns (x, the block's new state)."""
    a, new_state = mamba_mod.mamba2_apply(
        p["mamba"], rmsnorm(p["ln"], x), expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state, state=state)
    return x + a, new_state


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
    f32, ``context_len`` unused); for zamba2 ``{"groups": {"conv_x",
    "conv_bc", "ssm"}, "shared_kv": <one cache a group>, "tail": ...}``
    (the SSM state in f32)."""
    _check_block_type(cfg)
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

    def kv(lead):
        shape = lead + (batch, C, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "slot_pos": torch.zeros(lead + (C,), dtype=torch.int32,
                                        device=device)}
    if cfg.block_type == "attn":
        return {"kv": kv(_lead(cfg))}
    G, per, trailing = _hybrid_layout(cfg)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim

    def mst(*lead):
        return {"conv_x": torch.zeros(lead + (batch, mamba_mod.CONV_K - 1,
                                              d_in), dtype=dtype,
                                      device=device),
                "conv_bc": torch.zeros(lead + (batch, mamba_mod.CONV_K - 1,
                                               2 * cfg.ssm_state),
                                       dtype=dtype, device=device),
                "ssm": torch.zeros(lead + (batch, nh, cfg.ssm_head_dim,
                                           cfg.ssm_state),
                                   dtype=torch.float32, device=device)}
    st = {"groups": mst(G, per), "shared_kv": kv((G,))}
    if trailing:
        st["tail"] = mst(trailing)
    return st


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _remat(fn, train: bool, cfg):
    """``fn`` recomputed in backward when ``cfg.remat`` and training (the
    JAX package's ``jax.checkpoint`` of its scan bodies)."""
    if not (train and cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def forward(params, cfg, *, tokens=None, embeds=None, state=None,
            cur_pos: Optional[int] = None, return_cache=False,
            cache_len: Optional[int] = None):
    """Returns (hidden (B,S,D), aux_loss (the MoE blocks' sum, 0 without
    experts), state or None).

    * train:    state=None, return_cache=False
    * prefill:  state=None, return_cache=True  (decode state built from K/V)
    * decode:   state=<decode state>, S == 1; the state is updated in place

    rwkv6 and zamba2's mamba2 blocks prefill from a zero state; ``cur_pos``
    is not used there.
    """
    _check_block_type(cfg)
    dev = params["embed"]["embedding"].device
    if embeds is not None:
        x = torch.as_tensor(embeds, device=dev).to(COMPUTE_DTYPE)
    else:
        x = embed(params["embed"], torch.as_tensor(tokens, device=dev),
                  scale=cfg.post_block_norm)
    B, S, _ = x.shape
    decode = state is not None
    train = not decode and not return_cache
    new_state = None
    if decode:
        new_state = state
    elif return_cache:
        C = cache_len or cfg.kv_cache_len(S)
        new_state = init_decode_state(cfg, B, C, dtype=x.dtype, device=dev)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)

    def keep_kv(kv, tree, idx):
        if return_cache and not decode:
            for name, t in _kv_from_full(*kv, C).items():
                tree[name][idx].copy_(t)

    if cfg.block_type == "rwkv6":
        body = _remat(lambda p, x: _rwkv_block_apply(p, x, cfg)[0], train,
                      cfg)
        for i in range(cfg.n_layers):
            p = _index(params["blocks"], i)
            if train:
                x = body(p, x)
                continue
            x, st = _rwkv_block_apply(p, x, cfg,
                                      _index(state, i) if decode else None)
            _copy_into(new_state, st, i)
    elif cfg.block_type == "attn":
        for idx, window in _block_indices(cfg):
            cache = _index(state["kv"], idx) if decode else None

            def blk(p, x, window=window):
                x, aux, _ = _attn_block_apply(p, x, cfg, window=window)
                return x, aux
            p = _index(params["blocks"], idx)
            if train:
                x, aux = _remat(blk, train, cfg)(p, x)
            else:
                x, aux, kv = _attn_block_apply(p, x, cfg, window=window,
                                               cache=cache, cur_pos=cur_pos)
                keep_kv(kv, new_state["kv"], idx)
            aux_total = aux_total + aux
    else:
        G, per, trailing = _hybrid_layout(cfg)
        shared = params["shared_attn"]
        mamba = _remat(lambda p, x: _mamba_block_apply(p, x, cfg)[0], train,
                       cfg)
        attn = _remat(lambda p, x: _attn_block_apply(p, x, cfg, window=0)[0],
                      train, cfg)

        def mamba_run(tree, key, idx, x):
            p = _index(params[key], idx)
            if train:
                return mamba(p, x)
            x, ns = _mamba_block_apply(
                p, x, cfg, _index(state[tree], idx) if decode else None)
            _copy_into(new_state[tree], ns, idx)
            return x
        for g in range(G):
            for j in range(per):
                x = mamba_run("groups", "blocks", (g, j), x)
            if train:
                x = attn(shared, x)
            else:
                cache = _index(state["shared_kv"], g) if decode else None
                x, _, kv = _attn_block_apply(shared, x, cfg, window=0,
                                             cache=cache, cur_pos=cur_pos)
                keep_kv(kv, new_state["shared_kv"], g)
        for t in range(trailing):
            x = mamba_run("tail", "tail", t, x)
    x = rmsnorm(params["final_norm"], x)
    return x, aux_total, new_state


def _copy_into(stacked, tree, i) -> None:
    """Write ``tree``'s tensors into entry ``i`` (an int or a tuple) of the
    stacked ``stacked``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def logits_from_hidden(params, cfg, h):
    table = params["embed"]["embedding"].to(h.dtype)
    logits = h @ table.T
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def loss_fn(params, cfg, batch, aux_weight: float = 0.01):
    """The training loss: chunked cross-entropy over ``batch["labels"]``
    (masked by ``batch["mask"]`` if given) plus ``aux_weight`` times the
    MoE aux loss.  Returns (loss, {"ce", "aux"}), 0-d f32 tensors."""
    h, aux, _ = forward(params, cfg, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"))
    dev = h.device
    mask = batch.get("mask")
    loss = chunked_ce_loss(params["embed"], h,
                           torch.as_tensor(batch["labels"], device=dev),
                           chunk=cfg.loss_chunk,
                           final_softcap=cfg.final_softcap,
                           mask=None if mask is None
                           else torch.as_tensor(mask, device=dev))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _value_and_grad(params, cfg, batch, aux_weight):
    """(loss, metrics, grads): the gradients in the parameters' dtypes, as
    ``jax.value_and_grad``; the parameters themselves are not changed."""
    live = [t.detach().requires_grad_(t.is_floating_point())
            for t in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, live), cfg, batch,
                                aux_weight)
        diff = [t for t in live if t.requires_grad]
        grads = iter(torch.autograd.grad(loss, diff, allow_unused=True))
    out = []
    for t in live:
        g = next(grads) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, out))


def _check_spec_tree(params, specs, path=()) -> None:
    """``specs`` has ``params``' dict structure, with a spec or a sharding
    at every leaf."""
    if isinstance(params, Mapping):
        got = sorted(specs) if isinstance(specs, Mapping) else \
            type(specs).__name__
        if got != sorted(params):
            raise ValueError(f"grad_specs at {list(path)}: {got} does not "
                             f"match the parameters' keys {sorted(params)}")
        for k in params:
            _check_spec_tree(params[k], specs[k], path + (k,))
    elif not isinstance(specs, (sharding.PartitionSpec,
                                sharding.NamedSharding)):
        raise ValueError(f"grad_specs at {list(path)}: expected a "
                         f"PartitionSpec or NamedSharding, got "
                         f"{type(specs).__name__}")


def train_step(params, opt_state, batch, *, cfg, optimizer, aux_weight=0.01,
               n_microbatch: int = 1, grad_specs=None):
    """One optimizer step; with ``n_microbatch`` > 1 the batch is split
    along its first dim and the gradients of the sequential microbatches
    are accumulated in f32, then averaged (JAX's ``lax.scan`` over them).

    Returns (params, opt_state, metrics with ``loss`` and ``grad_norm``).
    ``optimizer.update`` may write ``params`` and ``opt_state`` in place
    (the port's ``optim.adamw`` and ``optim.sgd`` do): the returned trees
    are then the ones passed in.

    ``grad_specs``: optional PartitionSpec (or NamedSharding) tree matching
    ``params``.  JAX pins each gradient to it, which moves no value; one
    process has no mesh to pin to, so the tree is checked against
    ``params`` leaf for leaf (a mismatch raises, as JAX's ``tree.map``
    does) and the step is the one ``grad_specs=None`` computes."""
    if grad_specs is not None:
        _check_spec_tree(params, grad_specs)
    with tracing.span("step.fwd_bwd", counters=attn_mod.route_counts):
        loss, metrics, grads = _grads(params, cfg, batch, aux_weight,
                                      n_microbatch)
    with tracing.span("step.optimizer"):
        params, opt_state = optimizer.update(params, grads, opt_state)
    # the metrics' norm of the gradients (the clip computed its own)
    with tracing.span("step.grad_norm"):
        metrics = dict(metrics, loss=loss,
                       grad_norm=optimizer.global_norm(grads))
    return params, opt_state, metrics


def _grads(params, cfg, batch, aux_weight, n_microbatch: int):
    """(loss, metrics, grads) of the whole batch, or of its
    ``n_microbatch`` sequential microbatches: f32 sums of their gradients
    divided by their number, their losses and metrics averaged."""
    if n_microbatch <= 1:
        return _value_and_grad(params, cfg, batch, aux_weight)
    else:
        def split(x, i):
            x = torch.as_tensor(x)
            n = x.shape[0] // n_microbatch
            return x[i * n:(i + 1) * n]
        grads, losses, metss = None, [], []
        for i in range(n_microbatch):
            ub = {k: split(v, i) for k, v in batch.items()}
            l, met, g = _value_and_grad(params, cfg, ub, aux_weight)
            g = list(leaves(g))
            if grads is None:
                grads = [t.float() for t in g]
            else:
                for a, b in zip(grads, g):     # f32 += the widened grad
                    a.add_(b)
            del g
            losses.append(l)
            metss.append(met)
        grads = unflatten(params, [g.div_(n_microbatch) for g in grads])
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([m[k] for m in metss]).mean()
                   for k in metss[0]}
        return loss, metrics, grads


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
