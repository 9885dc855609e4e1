"""Model/run configuration for the assigned architectures.

One ``ModelConfig`` covers all six architecture families (dense / moe / ssm /
hybrid / vlm / audio); each assigned arch gets a module ``configs/<id>.py``
exporting ``CONFIG`` (the exact published shape) and ``REDUCED`` (a tiny
same-family config for CPU smoke tests).

A copy of the JAX package's ``configs/base.py`` (pure Python, so the port
keeps its own and imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Input shapes assigned to the LM family (seq_len, global_batch, kind).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention ---
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding-window size; 0 = full attention
    alt_local_global: bool = False   # gemma2: even layers local(window), odd global
    attn_softcap: float = 0.0        # gemma2 logit soft-capping (50.0)
    final_softcap: float = 0.0       # gemma2 final-logit soft-capping (30.0)
    post_block_norm: bool = False    # gemma2 sandwich norms
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- ssm / hybrid ---
    block_type: str = "attn"         # attn | rwkv6 | mamba2
    ssm_state: int = 0               # mamba2 state dim
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_dim: int = 4
    shared_attn_every: int = 0       # zamba2: one shared attn block per N ssm blocks
    # --- frontends (vlm / audio) ---
    embeds_input: bool = False       # model consumes precomputed embeddings (stub frontend)
    # --- numerics / memory ---
    loss_chunk: int = 512            # sequence chunk for vocab loss
    remat: bool = True
    # --- attention impl: "xla" (chunked jnp), "pallas", "pallas_interpret"
    attn_impl: str = "xla"
    # gradient-accumulation microbatches for the production train shapes
    # (small models need fewer: FSDP weight gathers repeat per microbatch)
    microbatches: int = 4
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def kv_cache_len(self, seq_len: int) -> int:
        """Per-layer KV-cache length for decode at context ``seq_len``.

        Sliding-window archs bound the cache to the window (ring buffer);
        gemma2's alternating stack still contains global layers, so it cannot
        bound the cache.
        """
        if self.window and not self.alt_local_global:
            return min(seq_len, self.window)
        return seq_len

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d                       # embed (tied head)
        per_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.block_type == "attn":
            per_ffn = 3 * d * self.d_ff
            if self.is_moe:
                per_ffn = per_ffn * self.n_experts + d * self.n_experts
            n += self.n_layers * (per_attn + per_ffn + 2 * d)
        elif self.block_type == "rwkv6":
            # time-mix (r,k,v,g,o + decay lora) + channel-mix
            per = 5 * d * d + 2 * d * self.d_ff + 6 * d * 32 * 2 + 4 * d
            n += self.n_layers * per
        elif self.block_type == "mamba2":
            d_in = self.ssm_expand * d
            per_m = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
            n_ssm = self.n_layers - self.n_shared_attn_applications()
            n += n_ssm * (per_m + 2 * d)
            n += (per_attn + 3 * d * self.d_ff + 2 * d)  # single shared block
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (3 * d * self.d_ff * self.n_experts)
        return dense + self.n_layers * 3 * d * self.d_ff * self.top_k

    def n_shared_attn_applications(self) -> int:
        if self.shared_attn_every <= 0:
            return 0
        return self.n_layers // (self.shared_attn_every + 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _registry():
    from . import (gemma2_2b, yi_9b, deepseek_67b, starcoder2_15b, mixtral_8x22b,
                   phi35_moe, rwkv6_3b, zamba2_7b, internvl2_26b, musicgen_medium,
                   paper_cnn)
    mods = [gemma2_2b, yi_9b, deepseek_67b, starcoder2_15b, mixtral_8x22b,
            phi35_moe, rwkv6_3b, zamba2_7b, internvl2_26b, musicgen_medium]
    return {m.CONFIG.name: m for m in mods}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mods = _registry()
    if name not in mods:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(mods)}")
    return mods[name].REDUCED if reduced else mods[name].CONFIG


def list_archs():
    return sorted(_registry())
