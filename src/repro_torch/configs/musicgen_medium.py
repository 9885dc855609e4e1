"""musicgen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens (stub frontend)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048,
    embeds_input=True,   # EnCodec frame embeddings arrive precomputed (stub)
    microbatches=2,
)

REDUCED = CONFIG.replace(
    name="musicgen-medium-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, loss_chunk=16,
)
