"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — Mamba+attention hybrid at a
1:7 interleave with MoE (16 experts, top-2).

72L d_model=8192 64H (GQA kv=8, d_head=128) d_ff=24576 vocab=65536.
Pattern (period 8): attention at index 3, Mamba elsewhere; MoE FFN on odd
indices, dense FFN on even (Jamba applies MoE every other layer).  Adam
moments are bf16 (398B params x fp32 moments would not fit 256 chips;
EXPERIMENTS.md §Dry-run)."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24_576,
    vocab_size=65_536,
    n_experts=16,
    top_k=2,
    moe_positions=(1, 3, 5, 7),
    period=8,
    attn_positions=(3,),
    ssm_state=128,
    ssm_expand=2,
    ssm_d_head=128,
    adam_dtype="bfloat16",
    accum_steps=8,
    source="arXiv:2403.19887; hf",
)
