"""Operations and bytes of the work a kernel needs in a step, from shapes
and the lengths actually served.  How many layers run each kernel is the
configuration's reference module's to say (``attention_layers``,
``moe_layers``), as are the model's FLOPs (``step_flops``).

Each input byte is counted once as read and each output byte once as
written, whatever a kernel reads again; only the rows a step needs count
(a decode step's active slots, a prefill chunk's valid tokens), not the
padding or the idle slots the program also computes.  bfloat16 values are
2 bytes, int32 and float32 4.
"""
from __future__ import annotations

import json
from pathlib import Path

BF16, I32 = 2, 4


def peaks() -> dict:
    return json.loads((Path(__file__).parent / "peaks.json").read_text())


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the work could take on the card (the larger of its
    operations over the bf16 peak and its bytes over the HBM bandwidth),
    as a share of ``seconds``."""
    p = peaks()
    least = max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
    return 100.0 * least / seconds


def paged_attention(arch: dict, lengths: list, page: int, layers: int
                    ) -> tuple:
    """(flops, bytes) of one decode step's paged reads over ``layers``
    attention layers: for each active slot attending L tokens, its K and
    V rows, its query and output rows, its page-table entries and
    length."""
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    flops = nbytes = 0
    for n in lengths:
        flops += 4 * hq * dh * n
        nbytes += (2 * n * hkv * dh * BF16 + 2 * hq * dh * BF16
                   + -(-n // page) * I32 + I32)
    return flops * layers, nbytes * layers


def dispatch_combine(arch: dict, tokens: int, layers: int) -> tuple:
    """(flops, bytes) of one step's MoE dispatch and combine over
    ``layers`` MoE layers for ``tokens`` routed rows of top-k choices
    each: dispatch reads the rows and their slots and writes k copies;
    combine reads the k expert rows, their bfloat16 weights and slots, and
    writes one row."""
    d, k = arch["d_model"], arch["top_k"]
    dispatch = tokens * d * BF16 + tokens * k * I32 + tokens * k * d * BF16
    combine = (tokens * k * d * BF16 + tokens * k * (BF16 + I32)
               + tokens * d * BF16)
    flops = 2 * tokens * k * d
    return flops * layers, (dispatch + combine) * layers

