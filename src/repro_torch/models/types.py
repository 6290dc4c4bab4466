"""Model / shape configuration types shared across the framework."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating layer pattern."""

    mixer: str   # "attn" | "ssm"
    ffn: str     # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (a ``--arch`` choice).  Frozen + hashable, so it can
    key caches and be compared field by field with the JAX package's twin."""

    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0                   # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 32_000

    # attention
    attention_kind: str = "full"      # full | swa
    window: int = 4_096               # SWA window
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_positions: tuple[int, ...] = ()   # pattern indices with MoE FFN;
                                          # () + n_experts>0 -> all positions
    capacity_factor: float = 1.25
    moe_group_size: int = 1_024       # tokens per dispatch group

    # layer pattern (hybrid archs)
    period: int = 1
    attn_positions: tuple[int, ...] = ()  # pattern indices that are attention
                                          # (hybrid); () -> family default

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_d_head: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    n_decoder_layers: int = 0
    decoder_len: int = 448            # text positions in train/prefill shapes
    cross_len: int = 1_500            # encoder frames seen by decode_step

    # training
    accum_steps: int = 1              # gradient-accumulation microbatches
    attn_impl: str = "auto"           # auto | reference | blocked | triangular
    kv_quant: bool = False            # int8 KV cache (decode memory term)

    # IO / numerics
    input_mode: str = "tokens"        # tokens | embeddings (stubbed frontend)
    tie_embeddings: bool = False
    norm_kind: str = "rms"            # rms | layer
    dtype: str = "bfloat16"
    adam_dtype: str = "float32"       # bf16 moments for very large models
    norm_eps: float = 1e-5
    max_position: int = 1 << 20

    # notes for DESIGN/EXPERIMENTS (citation tier etc.)
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_d_head

    def pattern(self) -> tuple[LayerSpec, ...]:
        """The repeating layer pattern (length = ``period``)."""
        specs = []
        for p in range(self.period):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.family == "hybrid":
                mixer = "attn" if p in self.attn_positions else "ssm"
            else:
                mixer = "attn"
            if self.d_ff <= 0:
                ffn = "none"
            elif self.n_experts > 0 and (
                not self.moe_positions or p in self.moe_positions
            ):
                ffn = "moe"
            else:
                ffn = "mlp"
            specs.append(LayerSpec(mixer, ffn))
        return tuple(specs)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers {self.n_layers} % period {self.period}"
        )
        return self.n_layers // self.period

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid / sliding-window archs."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention_kind == "swa"

    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cell_supported(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; else the documented reason."""
    if shape.name == "long_500k" and not model.supports_long_context():
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
