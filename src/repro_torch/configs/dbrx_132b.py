"""dbrx-132b [hf:databricks/dbrx-base; unverified] — fine-grained MoE,
16 experts top-4.  40L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=10752
vocab=100352.  Adam moments bf16 (132B params)."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10_752,
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    adam_dtype="bfloat16",
    accum_steps=4,
    source="hf:databricks/dbrx-base; unverified",
)
