"""zamba2-7b [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

81 logical layers: groups of 5 mamba2 blocks followed by one application of a
single *shared* attention block (13 applications), plus 3 trailing mamba2
blocks: 13*(5+1)+3 = 81.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32_000,
    block_type="mamba2", ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=5,
    subquadratic=True,   # SSM backbone; shared-attn caches are seq-sharded
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="zamba2-7b-reduced", n_layers=9, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
    loss_chunk=16,
)
