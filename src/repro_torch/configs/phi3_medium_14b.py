"""phi3-medium-14b [arXiv:2404.14219; unverified] — RoPE SwiGLU GQA dense.
40L d_model=5120 40H (GQA kv=10, d_head=128) d_ff=17920 vocab=100352."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_head=128,
    d_ff=17_920,
    vocab_size=100_352,
    accum_steps=2,
    source="arXiv:2404.14219; unverified",
)
