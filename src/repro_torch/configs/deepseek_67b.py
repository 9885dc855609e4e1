"""deepseek-67b [arXiv:2401.02954]: llama-arch GQA, 95 layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102_400,
    microbatches=4,
    loss_chunk=256,
)

REDUCED = CONFIG.replace(
    name="deepseek-67b-reduced", n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=192, vocab_size=512, loss_chunk=16,
)
