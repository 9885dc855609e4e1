"""gemma2-2b [arXiv:2408.00118]: local+global alternating attention, logit softcap."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab_size=256_000, head_dim=256,
    window=4096, alt_local_global=True,
    attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
    subquadratic=False,  # global layers remain full attention
    microbatches=2,
)

REDUCED = CONFIG.replace(
    name="gemma2-2b-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512, window=32, loss_chunk=16,
)
