"""internvl2-26b [arXiv:2404.16821]: InternViT (stub frontend) + InternLM2 backbone."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92_553,
    embeds_input=True,   # InternViT patch embeddings arrive precomputed (stub)
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="internvl2-26b-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, loss_chunk=16,
)
