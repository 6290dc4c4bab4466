"""Operations and bytes of the work a step needs, from shapes and the
lengths actually served.

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


def paged_attention(arch: dict, lengths: list, page: int) -> tuple:
    """(flops, bytes) of one decode step's paged reads over every layer:
    for each active slot attending L tokens, its K and V rows, its query
    and output rows, its page-table entries and length."""
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    flops = nbytes = 0
    for n in lengths:
        flops += 4 * hq * dh * n
        nbytes += (2 * n * hkv * dh * BF16 + 2 * hq * dh * BF16
                   + -(-n // page) * I32 + I32)
    return flops * arch["n_layers"], nbytes * arch["n_layers"]


def dispatch_combine(arch: dict, tokens: int) -> tuple:
    """(flops, bytes) of one step's MoE dispatch and combine over every
    layer for ``tokens`` routed rows of top-k choices each: dispatch
    reads the rows and their slots and writes k copies; combine reads the
    k expert rows, their bfloat16 weights and slots, and writes one row."""
    d, k = arch["d_model"], arch["top_k"]
    dispatch = tokens * d * BF16 + tokens * k * I32 + tokens * k * d * BF16
    combine = (tokens * k * d * BF16 + tokens * k * (BF16 + I32)
               + tokens * d * BF16)
    flops = 2 * tokens * k * d
    return flops * arch["n_layers"], (dispatch + combine) * arch["n_layers"]


def active_params(arch: dict) -> int:
    """Parameters one token multiplies with in the layers (no embedding,
    no head): attention, and the FFN or the router and top-k experts."""
    d, f = arch["d_model"], arch["d_ff"]
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    if arch["n_experts"]:
        ffn = d * arch["n_experts"] + arch["top_k"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return arch["n_layers"] * (attn + ffn)


def step_flops(arch: dict, kind: str, rows: list, start: int = 0,
               n_valid: int = 0) -> float:
    """Model FLOPs of a decode step (``rows``: attended lengths of its
    active slots) or of a prefill chunk (positions start .. start+n-1):
    2 x active parameters a token, attention's two products over the
    positions each token attends, and the head for each token whose
    logits the step needs (every decode row; a chunk's last position)."""
    per_pos = 4 * arch["n_layers"] * arch["n_heads"] * arch["d_head"]
    head = 2 * arch["d_model"] * arch["vocab_size"]
    if kind == "decode":
        return sum(2 * active_params(arch) + head + per_pos * n
                   for n in rows)
    n = n_valid
    attended = n * start + n * (n + 1) // 2
    return (n * 2 * active_params(arch) + per_pos * attended
            + (head if n else 0))
