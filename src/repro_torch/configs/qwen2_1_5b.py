"""qwen2-1.5b [arXiv:2407.10671; hf] — GQA with QKV bias, tied embeddings.
28L d_model=1536 12H (GQA kv=2, d_head=128) d_ff=8960 vocab=151936."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)
