"""whisper-small [arXiv:2212.04356; unverified] — encoder-decoder; the conv
frontend is a STUB per the assignment (``input_specs`` provides precomputed
frame embeddings).  12+12L d_model=768 12H (kv=12, d_head=64) d_ff=3072
vocab=51865.  LayerNorm, GELU MLPs, sinusoidal positions (learned positions
in the original; immaterial for a systems study — DESIGN.md §5)."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=24,             # 12 encoder + 12 decoder
    n_encoder_layers=12,
    n_decoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51_865,
    norm_kind="layer",
    rope_theta=0.0,          # absolute positions, not rotary
    decoder_len=448,
    cross_len=1500,
    input_mode="embeddings",
    source="arXiv:2212.04356; unverified",
)
