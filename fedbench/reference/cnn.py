"""Plain reference of synchronous FedAvg over the thesis' CNN (Listing 4.1).

Parameters are a dict ``{"c1w", "c1b", "c2w", "c2b", "fw", "fb"}``: the
convolution weights as (kh, kw, in, out), the dense weight as (flat,
classes) over the (h, w, c) flattening, images as (n, h, w, c) in [0, 1].
A worker's local training is ``epochs`` full-batch SGD steps on the mean
cross-entropy; the server's merge is the plain mean of every worker's
parameters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import tf32

Params = Dict[str, torch.Tensor]


def logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    for w, b in ((p["c1w"], p["c1b"]), (p["c2w"], p["c2b"])):
        h = F.conv2d(h, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)
        h = F.max_pool2d(F.relu(h), 2)
    h = h.permute(0, 2, 3, 1).flatten(1)
    return h @ p["fw"] + p["fb"]


def loss(p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits(p, x), y)


def local_sgd(p: Params, x: torch.Tensor, y: torch.Tensor, *, lr: float,
              epochs: int) -> Params:
    keys = list(p)
    cur = [p[k].detach() for k in keys]
    for _ in range(epochs):
        leaves = [t.clone().requires_grad_(True) for t in cur]
        with torch.enable_grad():
            grads = torch.autograd.grad(
                loss(dict(zip(keys, leaves)), x, y), leaves)
        cur = [t.detach() - lr * g for t, g in zip(leaves, grads)]
    return dict(zip(keys, cur))


def fedavg(models: Sequence[Params]) -> Params:
    return {k: torch.stack([m[k] for m in models]).mean(0)
            for k in models[0]}


def accuracy(p: Params, x: torch.Tensor, y: torch.Tensor,
             block: int = 2048) -> float:
    hits = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], block):
            hits += int((logits(p, x[i:i + block]).argmax(-1)
                         == y[i:i + block]).sum())
    return hits / x.shape[0]


def run_rounds(p0: Params, shards: Sequence[tuple], test: tuple, *,
               lr: float, epochs: int, rounds: int,
               use_tf32: bool = False) -> List[dict]:
    """``rounds`` synchronous rounds from ``p0``: every worker trains on its
    (x, y) shard from the global model, the server takes their mean.
    Returns per round {"params", "accuracy"} (on the test (x, y))."""
    out, p = [], p0
    with tf32(use_tf32):
        for _ in range(rounds):
            p = fedavg([local_sgd(p, x, y, lr=lr, epochs=epochs)
                        for x, y in shards])
            out.append({"params": p, "accuracy": accuracy(p, *test)})
    return out
