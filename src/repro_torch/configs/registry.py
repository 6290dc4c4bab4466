"""Architecture registry: ``--arch <id>`` resolution + smoke reductions."""
from __future__ import annotations

import dataclasses

from repro_torch.models.types import ModelConfig

from . import (dbrx_132b, h2o_danube_1_8b, internlm2_1_8b, internvl2_76b,
               jamba_1_5_large_398b, llama4_scout_17b_a16e, mamba2_2_7b,
               phi3_medium_14b, qwen2_1_5b, whisper_small)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        h2o_danube_1_8b.CONFIG,
        internlm2_1_8b.CONFIG,
        phi3_medium_14b.CONFIG,
        qwen2_1_5b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        dbrx_132b.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
        whisper_small.CONFIG,
        mamba2_2_7b.CONFIG,
        internvl2_76b.CONFIG,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config: small width/depth/experts, runnable on CPU
    in a smoke test (the same reduction as the reference's ``smoke``)."""
    cfg = get(name)
    n_layers = max(cfg.period, 2 if cfg.period == 1 else cfg.period)
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        window=32,
        moe_group_size=64,
        ssm_chunk=16,
    )
    if cfg.n_heads:
        updates.update(n_heads=4, n_kv_heads=2, d_head=16)
    if cfg.n_experts:
        updates.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_d_head=8)
    if cfg.family == "encdec":
        updates.update(n_layers=4, n_encoder_layers=2, n_decoder_layers=2,
                       decoder_len=16, cross_len=24)
    return dataclasses.replace(cfg, **updates)
