"""Minimal optimizers over nested dicts of tensors (port of
``repro/optim/optimizers.py``).

The state mirrors the parameter tree leaf for leaf.  ``adamw`` keeps f32
master weights, ``m`` and ``v`` in its state and bf16 live parameters;
``sgd`` updates the parameters in f32 and casts back.  Both compute the
JAX package's update op for op, one leaf at a time (so no f32 copy of the
whole gradient tree is made), and both write IN PLACE: ``update`` changes
the parameter and state tensors it is given and returns the same trees
(the step counter included).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (0-d f32)."""
    parts = [torch.sum(torch.square(x.to(torch.float32)))
             for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(parts)))


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (params, grads, state) -> (params, state)

    def global_norm(self, tree):
        return global_norm(tree)


def _clip_scale(grads, max_norm: Optional[float]):
    """The global-norm clip's factor ``min(1, max_norm / max(gn, 1e-9))``
    (a 0-d f32 tensor), or None without clipping."""
    if max_norm is None:
        return None
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _grad32(g: torch.Tensor, scale) -> torch.Tensor:
    g = g.to(torch.float32)
    return g if scale is None else g * scale


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          clip_norm: Optional[float] = 1.0,
          schedule: Optional[Callable] = None) -> Optimizer:
    """AdamW with f32 master weights in the optimizer state and bf16 live
    parameters (bf16 forward and backward, f32 m, v and master)."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        some = next(leaves(params))
        return {"master": tree_map(lambda p: p.to(torch.float32).clone(), params),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=some.device)}

    @torch.no_grad()
    def update(params, grads, state):
        scale = _clip_scale(grads, clip_norm)
        state["step"].add_(1)
        step = state["step"].to(torch.float32)
        lr_t = lr if schedule is None else schedule(state["step"]) * lr
        f32 = torch.float32
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=step.device),
                             step)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=step.device),
                             step)

        def leaf(p, g, mast, m, v):
            g = _grad32(g, scale)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            mast.sub_(lr_t * (u + weight_decay * mast))
            p.copy_(mast)
        tree_map(leaf, params, grads, state["master"], state["m"], state["v"])
        return params, state

    return Optimizer(init=init, update=update)


def sgd(lr: float = 0.01, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    """SGD, with heavy-ball momentum (an f32 buffer) when ``momentum``."""
    def init(params):
        some = next(leaves(params))
        step = torch.zeros((), dtype=torch.int32, device=some.device)
        if momentum:
            return {"mom": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
                "step": step}
        return {"step": step}

    @torch.no_grad()
    def update(params, grads, state):
        scale = _clip_scale(grads, clip_norm)
        if momentum:
            def leaf(p, g, mom):
                mom.mul_(momentum).add_(_grad32(g, scale))
                p.copy_(p.to(torch.float32) - lr * mom)
            tree_map(leaf, params, grads, state["mom"])
        else:
            def leaf(p, g):
                p.copy_(p.to(torch.float32) - lr * _grad32(g, scale))
            tree_map(leaf, params, grads)
        state["step"].add_(1)
        return params, state

    return Optimizer(init=init, update=update)
