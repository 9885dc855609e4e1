"""rwkv6-3b (Finch) [arXiv:2404.05892]: attention-free, data-dependent decay."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65_536,
    block_type="rwkv6", ssm_head_dim=64,
    subquadratic=True,
    microbatches=2,
)

REDUCED = CONFIG.replace(
    name="rwkv6-3b-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, ssm_head_dim=16, loss_chunk=16,
)
