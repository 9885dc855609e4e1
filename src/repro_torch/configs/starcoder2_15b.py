"""starcoder2-15b [arXiv:2402.19173]: GQA, RoPE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49_152,
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="starcoder2-15b-reduced", n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, loss_chunk=16,
)
