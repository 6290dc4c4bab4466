"""internvl2-76b [arXiv:2404.16821; unverified] — InternViT + LLM backbone.
The ViT frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch/text embeddings; the 80L LM backbone is modeled.
80L d_model=8192 64H (GQA kv=8, d_head=128) d_ff=28672 vocab=128256."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28_672,
    vocab_size=128_256,
    input_mode="embeddings",
    adam_dtype="bfloat16",
    accum_steps=4,
    source="arXiv:2404.16821; unverified",
)
