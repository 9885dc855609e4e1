"""The thesis' CNN (§4.2.4, Listing 4.1; port of ``repro/models/cnn.py``):
conv5x5(conv1)-relu-maxpool2-conv5x5(conv2)-relu-maxpool2-fc(n_classes)
over NHWC images, trained by full-batch SGD.

Parameters are a dict of tensors ``{"c1w", "c1b", "c2w", "c2b", "fw",
"fb"}`` in the JAX package's layout: conv weights HWIO, ``fw`` shaped
``(flat, n_classes)`` over the NHWC flattening.  That dict is what crosses
the wire, so packed vectors line up with the JAX package's; the weights
are permuted to PyTorch's OIHW only inside the convolution.  The
convolutions are library calls (``torch.nn.functional.conv2d``), as
JAX's are XLA's; every entry point runs its device through
``resolve_device`` so that cuDNN never computes them in TF32.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.paper_cnn import CNNConfig

Params = Dict[str, torch.Tensor]
KEYS = ("c1w", "c1b", "c2w", "c2b", "fw", "fb")


def init_cnn(generator: torch.Generator, cfg: CNNConfig,
             device=None) -> Params:
    """He-normal weights and zero biases, drawn from ``generator`` (a CPU
    generator, so the same seed gives the same weights on every device).
    For parity runs inject the JAX package's weights through
    :func:`params_from_numpy` instead."""
    device = resolve_device(device)
    c, hw = cfg.channels, cfg.image_hw

    def he(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * math.sqrt(2.0 / fan)).to(device)
    flat = (hw // 4) * (hw // 4) * cfg.conv2
    return {"c1w": he((5, 5, c, cfg.conv1), 25 * c),
            "c1b": torch.zeros(cfg.conv1, device=device),
            "c2w": he((5, 5, cfg.conv1, cfg.conv2), 25 * cfg.conv1),
            "c2b": torch.zeros(cfg.conv2, device=device),
            "fw": he((flat, cfg.n_classes), flat),
            "fb": torch.zeros(cfg.n_classes, device=device)}


def params_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's CNN parameters, exported as numpy arrays, as the
    port's parameters on ``device`` (f32 copies, same layout)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(d[k]), dtype=torch.float32,
                            device=device) for k in KEYS}


def _conv_relu_pool(h: torch.Tensor, w_hwio: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """NCHW: 5x5 SAME convolution (padding 2), bias, relu, 2x2 VALID
    max-pool."""
    h = F.conv2d(h, w_hwio.permute(3, 2, 0, 1), b, padding=2)
    return F.max_pool2d(torch.relu(h), 2)


def _logits_nchw(params: Params, x_nchw: torch.Tensor) -> torch.Tensor:
    h = _conv_relu_pool(x_nchw, params["c1w"], params["c1b"])
    h = _conv_relu_pool(h, params["c2w"], params["c2b"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flattening
    return h @ params["fw"] + params["fb"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    resolve_device(x.device)
    return x.permute(0, 3, 1, 2)


def cnn_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) float32 in [0, 1]."""
    return _logits_nchw(params, _nchw(x))


def _loss_nchw(params: Params, x_nchw: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    logits = _logits_nchw(params, x_nchw)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, y.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def cnn_loss(params: Params, batch: Mapping[str, torch.Tensor]
             ) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[y]`` over ``batch["x"]``
    (NHWC) and ``batch["y"]``."""
    return _loss_nchw(params, _nchw(batch["x"]), batch["y"])


def cnn_sgd_train(params: Params, x: torch.Tensor, y: torch.Tensor,
                  lr: float = 0.01, epochs: int = 1) -> Params:
    """``epochs`` full-batch SGD steps on all of ``x``.  Returns new
    tensors; the input dict is left as it was."""
    xc = _nchw(x)
    keys = tuple(params)
    p = {k: v.detach() for k, v in params.items()}
    for _ in range(int(epochs)):
        leaves = [p[k].requires_grad_(True) for k in keys]
        with torch.enable_grad():
            loss = _loss_nchw(dict(zip(keys, leaves)), xc, y)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            p = {k: w - lr * g for k, w, g in zip(keys, leaves, grads)}
    return p


def cnn_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
                 ) -> torch.Tensor:
    """Share of samples whose argmax logit is the label (0-d tensor)."""
    with torch.no_grad():
        pred = torch.argmax(cnn_logits(params, x), dim=-1)
        return torch.mean((pred == y).to(torch.float32))
