"""Analytic (napkin-math) FLOP model per (arch x shape) — the MODEL_FLOPS
reference for the roofline's useful-compute ratio.

Conventions: MODEL_FLOPS = 6*N*D for training (N = active params, D = tokens)
plus the attention term 12*L*H*hd*B*S*S_eff (causal band = S/2, window = W);
2*N*D for prefill; 2*N*B (+ attention cache reads are memory, not FLOPs) per
decode step.

A copy of the JAX package's ``launch/analytics.py`` (framework-free),
pointed at the port's configs.  ``model_flops`` also takes ``batch=`` and
``seq_len=`` so a run cut from one of ``SHAPES`` (fewer sequences, shorter
prompts) is counted at the size it ran.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import SHAPES, get_config


def _attn_flops_per_layer(cfg, B, S, train: bool) -> float:
    if cfg.block_type != "attn" and cfg.shared_attn_every <= 0:
        return 0.0
    hd, H = cfg.hd, cfg.n_heads
    if cfg.window and not cfg.alt_local_global:
        s_eff = min(S, cfg.window) / 1  # banded: each query sees <=W keys
        pair = S * s_eff
    else:
        pair = S * S / 2
    fwd = 4 * B * H * hd * pair        # QK^T + AV
    if cfg.alt_local_global:
        w_pair = S * min(S, cfg.window)
        fwd = 2 * B * H * hd * (pair + w_pair)  # half layers local, half global
    return fwd * (3 if train else 1)


def model_flops(arch: str, shape_name: str, *, batch: Optional[int] = None,
                seq_len: Optional[int] = None) -> dict:
    """MODEL_FLOPS of one step of ``arch`` at ``SHAPES[shape_name]``, or at
    ``batch`` sequences of ``seq_len`` tokens where those are given."""
    cfg = get_config(arch)
    info = SHAPES[shape_name]
    B = info["global_batch"] if batch is None else batch
    S = info["seq_len"] if seq_len is None else seq_len
    kind = info["kind"]
    n_act = cfg.n_active_params()

    if kind == "train":
        tokens = B * S
        core = 6 * n_act * tokens
        if cfg.block_type == "attn":
            attn = cfg.n_layers * _attn_flops_per_layer(cfg, B, S, True)
        elif cfg.block_type == "mamba2":
            attn = cfg.n_shared_attn_applications() * _attn_flops_per_layer(cfg, B, S, True)
        else:
            attn = 0.0
        total = core + attn
    elif kind == "prefill":
        tokens = B * S
        core = 2 * n_act * tokens
        if cfg.block_type == "attn":
            attn = cfg.n_layers * _attn_flops_per_layer(cfg, B, S, False)
        elif cfg.block_type == "mamba2":
            attn = cfg.n_shared_attn_applications() * _attn_flops_per_layer(cfg, B, S, False)
        else:
            attn = 0.0
        total = core + attn
    else:  # decode: one token per sequence
        core = 2 * n_act * B
        # decode attention: q(1) x K(S) per layer — 4*H*hd*S per seq per layer
        n_attn_layers = (cfg.n_layers if cfg.block_type == "attn"
                         else cfg.n_shared_attn_applications())
        C = cfg.kv_cache_len(S)
        attn = n_attn_layers * 4 * B * cfg.n_heads * cfg.hd * C
        total = core + attn
    return {"model_flops_total": float(total),
            "model_flops_core": float(core),
            "model_flops_attn": float(attn),
            "n_active_params": int(n_act)}
