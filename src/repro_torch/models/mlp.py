"""MLP classifier of the FL experiments (port of ``repro/models/mlp.py``).

Parameters are a dict of tensors, ``{"w1", "b1", "w2", "b2"}`` with
``w1`` shaped ``(in_dim, hidden)``: the JAX package's layout, so packed
vectors line up between the two.  Gradients come from autograd.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def init_mlp(generator: torch.Generator, *, in_dim: int, hidden: int = 128,
             n_classes: int = 10, device=None) -> Params:
    """He-normal weights and zero biases, drawn from ``generator`` (a CPU
    generator, so the same seed gives the same weights on every device).
    Torch cannot replay ``jax.random``: for parity runs inject the JAX
    package's weights through :func:`params_from_numpy` instead."""
    def he(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * math.sqrt(2.0 / fan)).to(device)
    w1 = he((in_dim, hidden), in_dim)
    w2 = he((hidden, n_classes), hidden)
    return {"w1": w1, "b1": torch.zeros(hidden, device=device),
            "w2": w2, "b2": torch.zeros(n_classes, device=device)}


def params_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's MLP parameters, exported as numpy arrays, as the
    port's parameters on ``device`` (f32 copies, same layout)."""
    return {k: torch.tensor(np.asarray(d[k]), dtype=torch.float32,
                            device=device)
            for k in ("w1", "b1", "w2", "b2")}


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[y]``."""
    logits = mlp_logits(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, y.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def _train(params: Params, x: torch.Tensor, y: torch.Tensor, lr: float,
           epochs: int, mb: int, mu: float) -> Params:
    n = x.shape[0]
    nb = max(n // mb, 1)
    xb = x[:nb * mb].reshape(nb, mb, *x.shape[1:])
    yb = y[:nb * mb].reshape(nb, mb)
    anchor = params           # FedProx: the fetched global
    keys = tuple(params)
    p = {k: v.detach() for k, v in params.items()}
    for _ in range(epochs):
        for b in range(xb.shape[0]):
            leaves = [p[k].requires_grad_(True) for k in keys]
            with torch.enable_grad():
                loss = mlp_loss(dict(zip(keys, leaves)), xb[b], yb[b])
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                if mu:
                    p = {k: w - lr * (g + mu * (w - anchor[k]))
                         for k, w, g in zip(keys, leaves, grads)}
                else:
                    p = {k: w - lr * g for k, w, g in zip(keys, leaves, grads)}
    return p


def mlp_sgd_train(params: Params, x: torch.Tensor, y: torch.Tensor,
                  lr: float = 0.1, epochs: int = 1, mb: int = 32) -> Params:
    """``epochs`` deterministic minibatch-SGD passes over the first
    ``max(n // mb, 1) * mb`` samples in order.  Returns new tensors; the
    input dict is left as it was."""
    return _train(params, x, y, lr, int(epochs), mb, 0.0)


def mlp_prox_train(params: Params, x: torch.Tensor, y: torch.Tensor,
                   lr: float = 0.1, epochs: int = 1, mb: int = 32,
                   mu: float = 0.0) -> Params:
    """FedProx local training: minibatch SGD on
    ``mlp_loss + mu/2 * ||p - params||^2``, anchored at the params this
    call receives (the worker's decode of the downlink).  ``mu == 0`` is
    exactly :func:`mlp_sgd_train`."""
    if mu == 0.0:
        return mlp_sgd_train(params, x, y, lr=lr, epochs=epochs, mb=mb)
    return _train(params, x, y, lr, int(epochs), mb, float(mu))


def mlp_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
                 ) -> torch.Tensor:
    """Share of samples whose argmax logit is the label (0-d tensor)."""
    with torch.no_grad():
        pred = torch.argmax(mlp_logits(params, x), dim=-1)
        return torch.mean((pred == y).to(torch.float32))
