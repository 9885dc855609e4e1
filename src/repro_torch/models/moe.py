"""Mixture-of-Experts FFN with GShard-style capacity dispatch (port of
``repro/models/moe.py``).

Tokens are grouped (``group_size``), routed top-k on an f32 softmax of the
router logits, and placed in per-expert buffers of ``capacity`` slots;
tokens that overflow an expert's buffer are dropped.  Slots are given in
choice-major order (every token's first choice before any second
choice), as in the JAX package.

The JAX package dispatches and combines with one-hot einsums.  Here the
same slot assignment and drop mask are computed from a cumulative count,
and tokens are moved by index: a token lands in exactly one slot per
kept choice, so the gather equals the one-hot product bit for bit, and
the combine adds the same (at most ``top_k``) f32 products before its
single rounding.  The expert GEMMs run over the padded ``(g, E, C, ·)``
buffers with ``torch.matmul`` (JAX computes them outside any Pallas
kernel, so there is no kernel to port here).
"""
from __future__ import annotations

import torch

from .layers import dense_init, silu

def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, *, lead=(), device=None) -> dict:
    """Router (d_model, E) and the experts' GLU projections (E, d_model,
    d_ff), (E, d_ff, d_model), each ``normal / sqrt(fan_in)`` in bf16;
    ``lead`` prepends stacking axes."""
    lead = tuple(lead)
    E = n_experts
    return {
        "router": dense_init(generator, lead + (d_model, E), d_model, device),
        "wi_gate": dense_init(generator, lead + (E, d_model, d_ff), d_model,
                              device),
        "wi_up": dense_init(generator, lead + (E, d_model, d_ff), d_model,
                            device),
        "wo": dense_init(generator, lead + (E, d_ff, d_model), d_ff, device),
    }


def capacity(G: int, top_k: int, capacity_factor: float, E: int) -> int:
    """Slots per expert and group: ``G * top_k * capacity_factor / E``
    rounded up to a multiple of 8 (at least 8), at most G."""
    cap = int(G * top_k * capacity_factor / E)
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, G)


def _groups(N: int, group_size: int) -> int:
    G = min(group_size, N)
    if N % G:
        raise ValueError(f"moe_apply: B*S = {N} tokens is neither <= the "
                         f"group size {group_size} nor a multiple of it")
    return G


def route(params, x: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25, group_size: int = 2048) -> dict:
    """The routing of ``moe_apply`` for x (B,S,D): ``probs`` (g,G,E) f32,
    ``gate_w`` (g,G,k) f32 renormalised, ``gate_idx`` (g,G,k) in JAX's
    ``top_k`` order (descending, the lowest index first among ties),
    ``pos`` (g,G,k): each choice's slot in its expert's buffer (choice
    major), ``keep`` (g,G,k): ``pos < capacity``, and ``cap``."""
    B, S, D = x.shape
    N = B * S
    E = params["router"].shape[-1]
    G = _groups(N, group_size)
    ng = N // G
    xg = x.reshape(ng, G, D)
    # a bf16 product is exact in f32: the f32 matmul of the converted
    # operands is JAX's preferred_element_type=float32
    logits = xg.float() @ params["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first among ties,
    # as lax.top_k does (bare torch.topk does not promise an order)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[..., :top_k], gate_idx[..., :top_k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(G, top_k, capacity_factor, E)
    # choice-major order: all first choices of the group, then all second
    cm = gate_idx.transpose(1, 2).reshape(ng, top_k * G)
    oh = torch.nn.functional.one_hot(cm, E).to(torch.int32)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1     # slot of each entry
    pos = pos.reshape(ng, top_k, G).transpose(1, 2)
    return {"probs": probs, "gate_w": gate_w, "gate_idx": gate_idx,
            "pos": pos, "keep": pos < cap, "cap": cap}


def _experts(xe, wi_gate, wi_up, wo):
    """(E, C, D) slots through each expert's GLU: (E, C, D)."""
    return (silu(xe @ wi_gate) * (xe @ wi_up)) @ wo


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 2048):
    """x: (B,S,D) -> (out (B,S,D) in x's dtype, the Switch load-balance aux
    loss, f32 0-d).  Differentiable: gradients reach x, the router (through
    the gates) and the experts, as JAX's (the slot assignment is constant,
    JAX's ``stop_gradient``)."""
    dt = x.dtype
    B, S, D = x.shape
    r = route(params, x, top_k=top_k, capacity_factor=capacity_factor,
              group_size=group_size)
    probs, gate_idx, pos, keep, cap = (r["probs"], r["gate_idx"], r["pos"],
                                       r["keep"], r["cap"])
    E = probs.shape[-1]
    ng, G, _ = probs.shape
    xg = x.reshape(ng, G, D)

    # dispatch: each kept (token, choice) into its expert's slot; dropped
    # ones into a spare slot ``cap`` that no expert reads (no host sync)
    k = gate_idx.shape[-1]
    gi = torch.arange(ng, device=x.device)[:, None, None].expand(ng, G, k)
    slot = torch.clamp(pos, max=cap)
    xe = torch.zeros((ng, E, cap + 1, D), dtype=dt, device=x.device)
    xe = xe.index_put((gi, gate_idx, slot),
                      xg[:, :, None, :].expand(ng, G, k, D))[:, :, :cap]
    # the experts, a group at a time: the (E, C, d_ff) intermediates of
    # one group live at once (groups are independent)
    wi_gate, wi_up, wo = (params[n].to(dt) for n in ("wi_gate", "wi_up",
                                                     "wo"))
    ye = torch.stack([_experts(xe[g], wi_gate, wi_up, wo)
                      for g in range(ng)])                  # (g,E,C,D)

    # combine: the bf16 gate times the expert output, f32 products summed
    # over the token's kept choices, rounded once (JAX's bf16 einsum)
    gate = r["gate_w"].to(dt).float()
    back = ye[gi, gate_idx, torch.clamp(pos, max=cap - 1)].float()
    contrib = torch.where(keep[..., None], back * gate[..., None], 0.0)
    y = contrib.sum(dim=2)

    # Switch-style load-balance aux loss over the first choices
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], E).float().mean(
        dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return y.to(dt).reshape(B, S, D), aux
