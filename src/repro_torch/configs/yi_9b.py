"""yi-9b [arXiv:2403.04652]: llama-arch GQA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64_000,
    microbatches=2,
)

REDUCED = CONFIG.replace(
    name="yi-9b-reduced", n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=512, loss_chunk=16,
)
