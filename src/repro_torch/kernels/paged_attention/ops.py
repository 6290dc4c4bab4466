"""Paged decode attention, dispatched on the operands' device.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``paged_attention.py``), which raises if
it cannot build or launch.  There is no fallback from one to the other.
"""
from __future__ import annotations

from . import paged_attention as kernel
from . import ref


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """q [B,H,D]; pages [N,page,Hkv,D]; page_table [B,P]; lengths [B] ->
    [B,H,D].  H % Hkv == 0: query head h reads KV head h // (H // Hkv)."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       lengths)
    if q.device.type == "cuda":
        return kernel.paged_attention(q, k_pages, v_pages, page_table,
                                      lengths)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")
