"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] —
MoE 16 experts top-1 plus one shared expert (Llama-4 architecture), early
fusion (text path modeled; fused modality tokens enter as ordinary tokens).
48L d_model=5120 40H (GQA kv=8, d_head=128) d_ff=8192 vocab=202048."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    accum_steps=2,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
