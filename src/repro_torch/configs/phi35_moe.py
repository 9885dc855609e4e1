"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 16 experts top-2."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32_064,
    n_experts=16, top_k=2,
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="phi3.5-moe-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512, n_experts=4, top_k=2, loss_chunk=16,
)
