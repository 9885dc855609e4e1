"""mixtral-8x22b [arXiv:2401.04088]: 8 experts top-2, sliding-window attention."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32_768,
    n_experts=8, top_k=2,
    window=4096,          # SWA bounds the decode cache -> long_500k runnable
    subquadratic=True,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="mixtral-8x22b-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, n_experts=4, top_k=2, window=32, loss_chunk=16,
)
