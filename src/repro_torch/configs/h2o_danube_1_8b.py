"""h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix with sliding-
window attention.  24L d_model=2560 32H (GQA kv=8, d_head=80) d_ff=6912
vocab=32000."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab_size=32_000,
    attention_kind="swa",
    window=4_096,
    source="arXiv:2401.16818; hf",
)
