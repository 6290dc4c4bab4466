"""mamba2-2.7b [arXiv:2405.21060; unverified] — attention-free SSD
(state-space duality).  64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128;
expand 2 -> d_inner 5120, 80 heads of 64."""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_d_head=64,
    rope_theta=0.0,
    source="arXiv:2405.21060; unverified",
)
